"""K7 past 256 tokens (deepfakedetection_tpu_torch/ops/attn4d.py; the long
kernel csrc/attn4d_long.cu) against the JAX package on the CPU, where the
wrapper runs the plain version.

(a) ``attn4d`` against ``attn4d_pallas(..., interpret=True)`` (which pads N to
    a multiple of 16) at N = 257, 289 (EfficientFormerV2-S1 at 544 px) and
    400 (at 640 px) with S1's 8 heads of d 32 and dv 128, and at an odd shape
    (3 heads, d 16, dv 40, 300 tokens), numpy-seeded bf16, to one bf16 step of
    the output's scale (``tests/test_torch_attn4d.py``'s tolerance).
(b) The long kernel's plan (``attn4d.long_plan``) at N = 144, 256, 400 and
    1,024 fits a block's shared memory and gives every (image, query row) to
    exactly one block; past ``LONG_MAX_TOKENS`` it is None.
(c) A narrow EfficientFormerV2 at 544 px (stages 3 and 4 attend over 17 x 17
    = 289 tokens, past the 256 the earlier long kernel took) against the JAX
    model, from one numpy-seeded tree carried over by ``state_dict_from_jax``:
    f32 logits within 5e-3 of their scale (``tests/test_cross_framework.py``'s
    gate) with equal argmax; bf16 (K7's plain version, two long launches a
    forward) within ``tests/test_torch_efficientformer_v2.py``'s 2.5e-2.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfakedetection_tpu.ops.pallas.attn4d import attn4d_pallas
from deepfakedetection_tpu_torch.ops import attn4d as k7
from tests.test_torch_long_tokens import (
    SMEM,
    SMS,
    _k7_inputs,
    _steps,
    assert_matches_jax,
    covered_rows,
    ef_port,
    fitted_efv2,
)

EF_SIZE = 544  # 17 x 17 tokens in stages 3 and 4


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


@pytest.mark.parametrize("N, h, d, dv", [(257, 8, 32, 128), (289, 8, 32, 128),
                                         (400, 8, 32, 128), (300, 3, 16, 40)])
def test_k7_past_256_tokens_matches_the_jax_kernel_in_interpret_mode(N, h, d, dv):
    B = 2
    arrays = _k7_inputs(B, N, h, d, dv, seed=N + h)
    q, k, v = (jnp.asarray(a, jnp.bfloat16) for a in arrays[:3])
    ref = np.asarray(attn4d_pallas(q, k, v, *(jnp.asarray(a) for a in arrays[3:]), num_heads=h,
                                   scale=d**-0.5, interpret=True), np.float32)
    args = ([torch.from_numpy(a).to(torch.bfloat16) for a in arrays[:3]]
            + [torch.from_numpy(a) for a in arrays[3:]])
    out = k7.attn4d(*args, num_heads=h, scale=d**-0.5)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == ref.shape
    err = float(np.abs(out.float().numpy() - ref).max())
    assert err <= _steps(ref), (N, err, _steps(ref))


@pytest.mark.parametrize("N", [144, 256, 400, 1024])
def test_k7_long_plan_fits_and_covers_every_query_row_once_at_any_n(N):
    B = 5
    plan = k7.long_plan(B, N, 8, 32, 128, SMS)
    assert plan is not None and plan.smem <= SMEM and plan.threads == k7.LONG_THREADS
    assert plan.stages >= 2 and plan.blocks == min(SMS, B * -(-N // k7.LONG_ROWS))
    rows = covered_rows(plan, B, N)
    assert {b: sorted(r) for b, r in rows.items()} == {b: list(range(N)) for b in range(B)}
    assert k7.long_plan(B, N, 3, 16, 40, SMS).smem <= SMEM


def test_k7_long_plan_ends_at_the_limit():
    assert k7.LONG_MAX_TOKENS == 46340  # N^2 of the [h, N, N] bias an int
    assert k7.long_plan(1, k7.LONG_MAX_TOKENS, 8, 32, 128, SMS) is not None
    assert k7.long_plan(1, k7.LONG_MAX_TOKENS + 1, 8, 32, 128, SMS) is None


@pytest.fixture(scope="module")
def efv2_544():
    return fitted_efv2(EF_SIZE, 2)


@pytest.mark.parametrize("dtype, gate", [("f32", 5e-3), ("bf16", 2.5e-2)])
def test_narrow_efficientformer_v2_at_544_matches_jax(efv2_544, dtype, gate):
    tree, x = efv2_544
    model = ef_port(tree, torch.float32 if dtype == "f32" else torch.bfloat16, EF_SIZE)
    assert model.kernel_launches_per_forward() == (
        {"k7": 0, "k7_long": 0} if dtype == "f32" else {"k7": 0, "k7_long": 2})
    assert_matches_jax(model, tree, x, dtype, gate)
