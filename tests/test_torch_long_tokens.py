"""K5 and K7 past 128 tokens (deepfakedetection_tpu_torch/ops/window_attn.py,
ops/attn4d.py; the long kernels csrc/window_attn_long.cu, csrc/attn4d_long.cu)
against the JAX package on the CPU, where the wrappers run the plain versions.

(a) K5 at N = 129, 196 (FasterViT's stage 4 at 448 px), 256, 257, 324 (at
    560 px) and 441 (at 672 px), head_dim 48, 2 heads, 2 windows, and at
    head_dim 128 past 208 tokens (which the earlier long backward refused),
    numpy-seeded bf16: ``window_attention``
    against ``window_mhsa_pallas(..., interpret=True)`` (which pads N to a
    multiple of 64 and masks the padded keys) and ``window_mhsa_xla``, to one
    bf16 step of the output's scale (the tolerance of
    ``tests/test_torch_window_attn.py``); ``window_attention_bwd`` against
    ``jax.vjp`` of ``window_mhsa_xla``, dq, dk and dv to two bf16 steps of
    each one's scale (``tests/test_torch_window_attn_bwd.py``'s), dbias to
    ``DBIAS_TOL`` of its scale: the JAX autodiff rounds dp to bf16 (the
    cotangent of the bf16 probabilities) where the port keeps it f32, so
    dbias, f32 on both sides, differs by that rounding only.
(b) K7 at N = 129, 196 and 256 (EfficientFormerV2-S1 at 512 px; 144 at 384),
    8 heads: ``attn4d`` against ``attn4d_pallas(..., interpret=True)``, to one
    bf16 step (``tests/test_torch_attn4d.py``'s); past 256 tokens
    ``tests/test_torch_k7_long.py``.
(c) The long kernels' launch plans (``long_fwd_plan``, ``long_bwd_plan``,
    ``attn4d.long_plan``) at FasterViT-2's 448 px stage 4 (both head
    configurations; eval batch 256, fine-tune batch 128), at every N up to
    784 and head_dim up to 128, and S1's 384 px attention (batch 256) fit a
    block's shared memory and give every (window, head, 16-row tile), or
    every (image, query row), to exactly one block; K5 takes any N and
    refuses head_dim past 128, K7 its limits (N past ``LONG_MAX_TOKENS``),
    before any launch.
(d) A narrow EfficientFormerV2 at 384 px (stages 3 and 4 attend over 12 x 12 =
    144 tokens) against the JAX model, from one numpy-seeded tree carried
    over by ``state_dict_from_jax``: f32 logits within 5e-3 of their scale
    (``tests/test_cross_framework.py``'s gate) with equal argmax; bf16 (K7's
    plain version) within ``tests/test_torch_efficientformer_v2.py``'s 2.5e-2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfakedetection_tpu.models.efficientformer_v2 import EfficientFormerV2 as JaxEFv2
from deepfakedetection_tpu.ops.attention import window_mhsa_pallas, window_mhsa_xla
from deepfakedetection_tpu.ops.pallas.attn4d import attn4d_pallas
from deepfakedetection_tpu_torch.models.efficientformer_v2 import EfficientFormerV2
from deepfakedetection_tpu_torch.ops import attn4d as k7
from deepfakedetection_tpu_torch.ops import window_attn as k5
from deepfakedetection_tpu_torch.runtime.convert import load_state_dict_strict, state_dict_from_jax
from tests.test_torch_efficientformer_v2 import NARROW as EF_NARROW
from tests.test_torch_efficientformer_v2 import seeded_tree

TOKENS = (129, 196, 256)
K5_TOKENS = TOKENS + (257, 324, 441)  # K5 takes any N
HEADS, WINDOWS, D = 2, 2, 48
DBIAS_TOL = 1e-2
SMEM = 232448
SMS = 132


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


def _steps(ref: np.ndarray, n: int = 1) -> float:
    """``n`` bf16 steps of the scale of ``ref``."""
    return float(n * 2.0 ** (np.floor(np.log2(np.abs(ref).max())) - 7))


def _k5_inputs(N, seed):
    rng = np.random.default_rng(seed)
    C = HEADS * D
    qkv = torch.from_numpy(rng.normal(size=(WINDOWS, N, 3 * C)).astype(np.float32))
    bias = torch.from_numpy(rng.normal(size=(HEADS, N, N)).astype(np.float32))
    dout = torch.from_numpy(rng.normal(size=(WINDOWS, N, C)).astype(np.float32))
    return qkv.to(torch.bfloat16), bias, dout.to(torch.bfloat16)


def _jax_heads(qkv):
    """q, k, v [B, N, h, d] jnp bf16 from the port's [B, N, 3C]."""
    B, N, C3 = qkv.shape
    C = C3 // 3
    j = jnp.asarray(qkv.float().numpy(), jnp.bfloat16)
    return [j[..., i * C:(i + 1) * C].reshape(B, N, HEADS, D) for i in range(3)]


@pytest.mark.parametrize("N", K5_TOKENS)
def test_k5_forward_matches_the_jax_kernel_and_xla(N):
    qkv, bias, _ = _k5_inputs(N, seed=N)
    scale = D**-0.5
    q, k, v = _jax_heads(qkv)
    got = k5.window_attention(qkv, bias, num_heads=HEADS, scale=scale)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == (WINDOWS, N, HEADS * D)
    for ref in (window_mhsa_pallas(q, k, v, jnp.asarray(bias.numpy()), scale=scale,
                                   interpret=True),
                window_mhsa_xla(q, k, v, jnp.asarray(bias.numpy()), scale=scale)):
        ref = np.asarray(ref, np.float32)
        err = float(np.abs(got.float().numpy() - ref).max())
        assert err <= _steps(ref), (N, err, _steps(ref))


@pytest.mark.parametrize("N", K5_TOKENS)
def test_k5_backward_matches_jax_grad_of_the_xla_path(N):
    qkv, bias, dout = _k5_inputs(N, seed=10 + N)
    scale = D**-0.5
    q, k, v = _jax_heads(qkv)

    def fwd(q, k, v, b):
        return window_mhsa_xla(q, k, v, b, scale=scale)

    _, vjp = jax.vjp(fwd, q, k, v, jnp.asarray(bias.numpy()))
    jq, jk, jv, jb = vjp(jnp.asarray(dout.float().numpy(), jnp.bfloat16))
    dqkv, dbias = k5.window_attention_bwd(qkv, bias, dout, num_heads=HEADS, scale=scale)
    C = HEADS * D
    for i, ref in enumerate((jq, jk, jv)):
        ref = np.asarray(ref, np.float32).reshape(WINDOWS, N, C)
        err = float(np.abs(dqkv[..., i * C:(i + 1) * C].float().numpy() - ref).max())
        assert err <= _steps(ref, 2), ("qkv"[i], N, err, _steps(ref, 2))
    jb = np.asarray(jb, np.float32)
    assert float(np.abs(dbias.numpy() - jb).max()) <= DBIAS_TOL * float(np.abs(jb).max())
    # and the autograd Function takes the same backward through the wrapper
    leaf = qkv.clone().requires_grad_(True)
    k5.window_attention(leaf, bias, num_heads=HEADS, scale=scale).backward(dout)
    assert torch.equal(leaf.grad, dqkv)


def test_k5_backward_at_head_dim_128_past_208_tokens_matches_jax_grad():
    """The d-128 backward past 208 tokens, which the earlier long kernel's
    shared memory refused (FasterViT-2's tpu configuration at 560 px: 324
    tokens of 6 heads of 128), one head here."""
    N, d = 324, 128
    rng = np.random.default_rng(7)
    qkv = torch.from_numpy(rng.normal(size=(1, N, 3 * d)).astype(np.float32)).to(torch.bfloat16)
    bias = torch.from_numpy(rng.normal(size=(1, N, N)).astype(np.float32))
    dout = torch.from_numpy(rng.normal(size=(1, N, d)).astype(np.float32)).to(torch.bfloat16)
    j = jnp.asarray(qkv.float().numpy(), jnp.bfloat16)
    q, k, v = (j[..., i * d:(i + 1) * d].reshape(1, N, 1, d) for i in range(3))
    _, vjp = jax.vjp(lambda q, k, v, b: window_mhsa_xla(q, k, v, b, scale=d**-0.5), q, k, v,
                     jnp.asarray(bias.numpy()))
    refs = vjp(jnp.asarray(dout.float().numpy(), jnp.bfloat16))
    dqkv, dbias = k5.window_attention_bwd(qkv, bias, dout, num_heads=1, scale=d**-0.5)
    for i, ref in enumerate(refs[:3]):
        ref = np.asarray(ref, np.float32).reshape(1, N, d)
        err = float(np.abs(dqkv[..., i * d:(i + 1) * d].float().numpy() - ref).max())
        assert err <= _steps(ref, 2), ("qkv"[i], err, _steps(ref, 2))
    jb = np.asarray(refs[3], np.float32)
    assert float(np.abs(dbias.numpy() - jb).max()) <= DBIAS_TOL * float(np.abs(jb).max())


def _k7_inputs(B, N, h, d, dv, seed):
    rng = np.random.default_rng(seed)

    def bf16(a):
        return torch.from_numpy(a.astype(np.float32)).to(torch.bfloat16).float().numpy()

    return [bf16(rng.normal(size=(B, N, h * d))), bf16(rng.normal(size=(B, N, h * d))),
            bf16(rng.normal(size=(B, N, h * dv))),
            (rng.normal(size=(h, N, N)) * 0.1).astype(np.float32),
            (rng.normal(size=(h, h)) * 0.3).astype(np.float32),
            (rng.normal(size=(h,)) * 0.1).astype(np.float32),
            (rng.normal(size=(h, h)) * 0.3).astype(np.float32),
            (rng.normal(size=(h,)) * 0.1).astype(np.float32)]


@pytest.mark.parametrize("N", TOKENS)
def test_k7_matches_the_jax_kernel_in_interpret_mode(N):
    B, h, d, dv = 2, 8, 16, 32
    arrays = _k7_inputs(B, N, h, d, dv, seed=N)
    q, k, v = (jnp.asarray(a, jnp.bfloat16) for a in arrays[:3])
    ref = np.asarray(attn4d_pallas(q, k, v, *(jnp.asarray(a) for a in arrays[3:]), num_heads=h,
                                   scale=d**-0.5, interpret=True), np.float32)
    args = ([torch.from_numpy(a).to(torch.bfloat16) for a in arrays[:3]]
            + [torch.from_numpy(a) for a in arrays[3:]])
    out = k7.attn4d(*args, num_heads=h, scale=d**-0.5)
    assert out.dtype == torch.bfloat16 and tuple(out.shape) == ref.shape
    err = float(np.abs(out.float().numpy() - ref).max())
    assert err <= _steps(ref), (N, err, _steps(ref))


# FasterViT-2 at 448 px: stage 4 is 14 x 14 = 196 tokens of C 768
K5_SHAPES = {"official": (16, 48), "tpu": (6, 128)}  # heads, head_dim


def _covers_every_tile_once(plan, blocks: int, B: int, N: int, heads: int) -> bool:
    """Every (window, head, 16-row tile) exactly once over the blocks."""
    tiles = sorted(t for block in range(blocks) for t in plan.tiles(block, B, N, heads))
    return tiles == [(w, h, t) for w in range(B) for h in range(heads) for t in range(-(-N // 16))]


def _fits(plan) -> bool:
    """A long plan's blocks fit an H100 block's shared memory, two an SM."""
    smems = (plan.smem,) if isinstance(plan, k5.LongFwdPlan) else (plan.rows_smem, plan.cols_smem)
    return all(s <= SMEM and 2 * (s + 1024) <= k5.SM_SMEM_BYTES for s in smems)


@pytest.mark.parametrize("config", K5_SHAPES)
def test_k5_long_plans_fit_and_cover_every_window_once(config):
    heads, d = K5_SHAPES[config]
    fwd = k5.long_fwd_plan(256, 196, heads, d, SMS)
    assert fwd is not None and _fits(fwd) and fwd.blocks == 2 * SMS
    assert _covers_every_tile_once(fwd, fwd.blocks, 256, 196, heads)
    bwd = k5.long_bwd_plan(128, 196, heads, d, SMS)
    assert bwd is not None and _fits(bwd) and bwd.blocks(heads) <= 2 * SMS
    assert _covers_every_tile_once(bwd, bwd.blocks(heads), 128, 196, heads)
    windows = [w for part in range(bwd.parts) for w in bwd.windows(128, part)]
    assert windows == list(range(128))  # each (head, group)'s parts, in order, once each


@pytest.mark.parametrize("N", [129, 196, 257, 324, 441, 576, 784])
@pytest.mark.parametrize("d", [16, 40, 48, 64, 128])
def test_k5_long_plans_fit_and_cover_any_window(N, d):
    """Only tiles live in shared memory: every N, at every head_dim, has
    plans that fit two blocks an SM and cover each tile once."""
    B, heads = 3, 5
    fwd, bwd = k5.long_fwd_plan(B, N, heads, d, SMS), k5.long_bwd_plan(B, N, heads, d, SMS)
    assert fwd is not None and bwd is not None and _fits(fwd) and _fits(bwd)
    assert fwd.groups == bwd.groups == -(-N // 64)
    assert _covers_every_tile_once(fwd, fwd.blocks, B, N, heads)
    assert _covers_every_tile_once(bwd, bwd.blocks(heads), B, N, heads)


def test_k5_refuses_what_the_long_kernels_do_not_take():
    """The old limits compute: N past 256 forward and backward, and the
    backward at head_dim 128 past 208 tokens; head_dim past 128 is refused."""
    assert k5.long_bwd_plan(4, 324, 6, 128) is not None
    qkv = torch.zeros(1, 257, 3 * 16, dtype=torch.bfloat16)
    bias = torch.zeros(1, 257, 257)
    assert k5.window_attention(qkv, bias, num_heads=1, scale=0.1).shape == (1, 257, 16)
    wide = torch.zeros(1, 209, 3 * 128, dtype=torch.bfloat16)
    dqkv, dbias = k5.window_attention_bwd(wide, torch.zeros(1, 209, 209),
                                          wide[..., :128].contiguous(), num_heads=1, scale=0.1)
    assert dqkv.shape == (1, 209, 384) and dbias.shape == (1, 209, 209)
    assert k5.long_fwd_plan(4, 324, 6, 129) is None and k5.long_bwd_plan(4, 324, 6, 129) is None
    too_wide = torch.zeros(1, 324, 3 * 129, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="head_dim <= 128"):
        k5.window_attention(too_wide, torch.zeros(1, 324, 324), num_heads=1, scale=0.1)


@pytest.mark.parametrize("N", [130, 324])
def test_k5_refuses_a_head_dim_past_128_in_both_directions(N):
    qkv = torch.zeros(1, N, 3 * 136, dtype=torch.bfloat16)
    bias = torch.zeros(1, N, N)
    with pytest.raises(ValueError, match="head_dim=136"):
        k5.window_attention(qkv, bias, num_heads=1, scale=0.1)
    with pytest.raises(ValueError, match="head_dim=136"):
        k5.window_attention_bwd(qkv, bias, qkv[..., :136].contiguous(), num_heads=1, scale=0.1)


def covered_rows(plan, B: int, N: int) -> dict[int, list[int]]:
    """Each image's query rows over the plan's blocks, in block order."""
    rows = {}
    for block in range(plan.blocks):
        for b, r in plan.items(block, B, N):
            rows.setdefault(b, []).extend(r)
    return rows


def test_k7_long_plan_fits_and_covers_every_query_row_once():
    B, N = 256, 144  # S1 at 384 px: 12 x 12 tokens, 8 heads, d 32, dv 128
    plan = k7.long_plan(B, N, 8, 32, 128, SMS)
    assert plan is not None and plan.smem <= SMEM and plan.threads == k7.LONG_THREADS
    rows = covered_rows(plan, B, N)
    assert {b: sorted(r) for b, r in rows.items()} == {b: list(range(N)) for b in range(B)}
    assert k7.long_plan(B, 256, 8, 32, 128, SMS).smem <= SMEM  # 512 px
    assert k7.long_plan(B, 256, 8, 64, 256, SMS) is None  # dv past the long kernel's 128
    assert k7.long_plan(B, 144, 9, 32, 128, SMS) is None  # more heads than the kernels take
    n = k7.LONG_MAX_TOKENS + 1  # one past the limit: refused before the bias is read
    args = [torch.zeros(1, n, 8 * 16, dtype=torch.bfloat16)] * 2 + [
        torch.zeros(1, n, 8 * 8, dtype=torch.bfloat16), torch.zeros(1, 1, 1).expand(8, n, n),
        torch.zeros(8, 8), torch.zeros(8), torch.zeros(8, 8), torch.zeros(8)]
    with pytest.raises(ValueError, match=f"N <= {k7.LONG_MAX_TOKENS}"):
        k7.attn4d(*args, num_heads=8, scale=0.25)


EF_SIZE = 384


def fitted_efv2(size: int, n: int):
    """A narrow EfficientFormerV2's numpy-seeded JAX tree at ``size`` px and
    ``n`` seeded images, its head along the features' first principal
    direction, which spreads the logits."""
    tree = seeded_tree(EF_NARROW, size, np.random.default_rng(0))
    x = np.random.default_rng(1).normal(size=(n, size, size, 3)).astype(np.float32)
    model = ef_port(tree, torch.float32, size)
    feats = []
    hook = model.head.register_forward_hook(lambda _m, inp, _o: feats.append(inp[0]))
    with torch.no_grad():
        model(torch.from_numpy(x).permute(0, 3, 1, 2))
    hook.remove()
    f = feats[0].double().numpy()
    centred = f - f.mean(0)
    direction = np.linalg.svd(centred, full_matrices=False)[2][0]
    scale = 2.0 / float((centred @ direction).std())
    kernel = np.zeros((f.shape[1], 2), np.float32)
    kernel[:, 1] = scale * direction
    bias = np.array([0.0, -scale * float(f.mean(0) @ direction)], np.float32)
    for name in ("head", "head_dist"):
        tree["params"][name] = {"kernel": kernel, "bias": bias}
    return tree, x


@pytest.fixture(scope="module")
def efv2_384():
    return fitted_efv2(EF_SIZE, 4)


def ef_port(tree, dtype, size: int = EF_SIZE):
    model = EfficientFormerV2(2, **EF_NARROW, img_size=size, dtype=dtype).eval()
    load_state_dict_strict(model, state_dict_from_jax(tree, "efficientformerv2"))
    return model


@pytest.mark.parametrize("dtype, gate", [("f32", 5e-3), ("bf16", 2.5e-2)])
def test_narrow_efficientformer_v2_at_384_matches_jax(efv2_384, dtype, gate):
    tree, x = efv2_384
    model = ef_port(tree, torch.float32 if dtype == "f32" else torch.bfloat16)
    assert model.kernel_launches_per_forward() == (
        {"k7": 0, "k7_long": 0} if dtype == "f32" else {"k7": 0, "k7_long": 2})
    assert_matches_jax(model, tree, x, dtype, gate)


def assert_matches_jax(model, tree, x, dtype: str, gate: float) -> None:
    """The port's logits within ``gate`` of the JAX model's scale, with equal
    argmax where the JAX logits are well apart."""
    with torch.no_grad():
        got = model(torch.from_numpy(x).permute(0, 3, 1, 2)).float().numpy()
    with jax.default_matmul_precision("highest"):
        want = np.asarray(JaxEFv2(num_classes=2, dtype=jnp.float32 if dtype == "f32"
                                  else jnp.bfloat16, **EF_NARROW).apply(
            tree, jnp.asarray(x), train=False), np.float32)
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    assert rel < gate, (dtype, rel)
    wide = np.abs(want[:, 1] - want[:, 0]) > 2 * gate * np.abs(want).max()
    assert wide.sum() >= len(x) // 2
    np.testing.assert_array_equal(got.argmax(-1)[wide], want.argmax(-1)[wide])
