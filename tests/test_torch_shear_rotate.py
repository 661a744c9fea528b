"""K4: the port's three-shear rotation on the CPU (its plain version, which
the wrapper runs for CPU tensors) against the JAX package's
``rotate_batch(..., interpret=True)``, on the same bf16 images and angles.

Tolerance: one bf16 step per pass, three passes: max|d| <= 3 * 2**-8 on
images in [0, 1]. Both sides blend two taps in f32 and round to bf16 after
each pass; only the last bit of ``tan``/``sin`` can differ between the two
libraries, so at most one element in a thousand may differ at all (measured:
none, at every case below).
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfakedetection_tpu.ops.pallas import shear_rotate as jax_shear
from deepfakedetection_tpu_torch.ops import shear_rotate

BOUND = math.radians(13.7)  # the rotation range the augmentation sends to K4
STEP = 2.0**-8  # one bf16 step at values just under 1

CASES = [
    # (B, H, W, max_theta, thetas)
    (2, 48, 48, 0.24, [0.0, 0.0]),
    (2, 48, 48, 0.24, [0.05, -0.05]),
    (2, 48, 48, 0.24, [0.17, -0.17]),
    (2, 64, 64, BOUND, [BOUND, -BOUND]),
    (2, 40, 40, 0.45, [0.45, -0.45]),
    (4, 37, 45, BOUND, [0.0, 0.05, -0.17, BOUND]),  # odd H != W, one angle per image
    (3, 45, 37, 0.45, [0.3, -0.44, 0.1]),
    (2, 70, 90, 0.24, [0.2, -0.11]),  # several 32-row blocks, a ragged last one
]


def _images(B, H, W, seed):
    rng = np.random.default_rng(seed)
    return rng.random((B, H, W, 3)).astype(np.float32)


@pytest.mark.parametrize("B,H,W,max_theta,thetas", CASES)
def test_plain_rotation_matches_jax_interpret(B, H, W, max_theta, thetas):
    img = _images(B, H, W, H * W + B)
    th = np.asarray(thetas, np.float32)
    want = np.asarray(
        jax_shear.rotate_batch(
            jnp.asarray(img).astype(jnp.bfloat16), jnp.asarray(th), max_theta=max_theta,
            interpret=True,
        ).astype(jnp.float32)
    )
    before = shear_rotate.rotate_batch.launches
    got = shear_rotate.rotate_batch(
        torch.from_numpy(img).to(torch.bfloat16), torch.from_numpy(th), max_theta=max_theta
    )
    assert shear_rotate.rotate_batch.launches == before  # the CPU runs no kernel
    assert got.dtype == torch.bfloat16 and got.shape == (B, H, W, 3)
    diff = np.abs(got.float().numpy() - want)
    assert diff.max() <= 3 * STEP, diff.max()
    assert (diff > 0).mean() <= 1e-3
    if not any(thetas):
        np.testing.assert_array_equal(got.float().numpy(), want)


def test_zero_angle_is_identity():
    img = torch.from_numpy(_images(2, 33, 31, 0)).to(torch.bfloat16)
    out = shear_rotate.rotate_batch(img, torch.zeros(2), max_theta=0.2)
    torch.testing.assert_close(out, img, atol=0, rtol=0)


def test_rotation_is_not_one_bilinear_warp():
    """Three bf16 passes sample differently from a single bilinear rotation
    (PARITY delta 14): at 0.17 rad the two differ well above bf16 noise."""
    from deepfakedetection_tpu_torch.data.augment import affine_sample

    img = _images(1, 48, 48, 1)
    th = torch.tensor([0.17])
    shear = shear_rotate.rotate_batch(torch.from_numpy(img).to(torch.bfloat16), th,
                                      max_theta=0.24).float()
    window = torch.tensor([[0.0, 0.0, 1.0, 1.0]])
    warp = affine_sample(torch.from_numpy(img), window, th, torch.ones(1), 48)
    assert float((shear - warp)[:, 12:-12, 12:-12].abs().max()) > 4 * STEP


def test_angles_beyond_the_shear_bound_raise():
    img = torch.zeros(1, 16, 16, 3, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="0.45"):
        shear_rotate.rotate_batch(img, torch.tensor([0.5]), max_theta=0.5)
    with pytest.raises(ValueError, match="bf16"):
        shear_rotate.rotate_batch(img.float(), torch.tensor([0.1]), max_theta=0.2)
    with pytest.raises(ValueError, match="thetas"):
        shear_rotate.rotate_batch(img, torch.tensor([0.1, 0.2]), max_theta=0.2)
