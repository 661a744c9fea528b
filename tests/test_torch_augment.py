"""The port's training augmentation (``data/augment.py``) against the JAX
package's, given the same parameters.

Each part's apply half gets the draws the JAX function makes from its key
(recomputed here with ``jax.random`` exactly as the JAX code splits the key),
so both frameworks run the same crop windows, flips, angles, jitter factors
and erasing rectangles. The whole ``augment_batch`` is held the same way:
the test draws every parameter as ``_augment_jit`` does and hands them to the
port's ``apply_augment``; on the JAX side ``shear_rotate.rotate_batch`` is
monkeypatched to ``interpret=True`` so the shear mode runs on the CPU.

Tolerances: each f32 part (warps, jitter) to 1e-4 absolute on outputs of
unit scale (the two libraries sum the matmuls in other orders); erasing
exactly. The whole pipeline without the shear to 5e-4 after normalisation,
which divides by std 0.225 (measured max 6.0e-5, gather mode). The shear
path to 2e-2: the canvas goes through three bf16 roundings and one bf16 step
of a unit pixel is 3.9e-3 before normalisation (measured max 9.2e-4). The
port's own sampling is held by its ranges, shapes and determinism.
"""

import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfakedetection_tpu.data import augment as jax_aug
from deepfakedetection_tpu.data.transforms import build_train_plan
from deepfakedetection_tpu.ops.pallas import shear_rotate as jax_shear
from deepfakedetection_tpu_torch.data import augment

JITTER = (0.2, 0.2, 0.2, 0.05)  # the EfficientNet recipe's
B = 3


def _plan(img_size, **toggles):
    return build_train_plan(img_size, toggles, recipe_defaults={}, jitter_params=JITTER)


def _canvas(plan, seed=0):
    rng = np.random.default_rng(seed)
    S = plan.host_canvas_size
    return rng.integers(0, 256, size=(B, S, S, 3), dtype=np.uint8)


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32).copy())


def _u(key, shape=(B,), lo=0.0, hi=1.0):
    return jax.random.uniform(key, shape, minval=lo, maxval=hi)


def _jax_crop_draws(key, plan, H, W):
    """The draws of ``_sample_crop`` in ``AugParams.crop`` layout."""
    S = plan.img_size
    if plan.small_images:
        ky, kx = jax.random.split(key)
        ty = jax.random.randint(ky, (B,), 0, max(H - S, 0) + 1)
        tx = jax.random.randint(kx, (B,), 0, max(W - S, 0) + 1)
        return np.stack([ty, tx, np.zeros(B), np.zeros(B)], 1)
    ka, kr, ky, kx = jax.random.split(key, 4)
    return np.stack([
        _u(ka, lo=plan.rrc_scale[0], hi=plan.rrc_scale[1]),
        _u(kr, lo=math.log(plan.rrc_ratio[0]), hi=math.log(plan.rrc_ratio[1])),
        _u(ky), _u(kx),
    ], 1)


def _jax_jitter_draws(key, plan):
    b, c, s, h = plan.jitter
    kb, kc, ks, kh = jax.random.split(key, 4)
    return np.stack([
        _u(kb, (B, 1, 1, 1), max(0.0, 1 - b), 1 + b).reshape(B),
        _u(kc, (B, 1, 1, 1), max(0.0, 1 - c), 1 + c).reshape(B),
        _u(ks, (B, 1, 1, 1), max(0.0, 1 - s), 1 + s).reshape(B),
        _u(kh, (B,), -h, h),
    ], 1)


def _jax_erase_draws(key, plan):
    kp, ka, kr, ky, kx = jax.random.split(key, 5)
    return np.stack([
        (_u(kp) < plan.erasing_p).astype(np.float32),
        _u(ka, lo=plan.erasing_scale[0], hi=plan.erasing_scale[1]),
        _u(kr, lo=math.log(plan.erasing_ratio[0]), hi=math.log(plan.erasing_ratio[1])),
        _u(ky), _u(kx),
    ], 1)


def _jax_params(key, plan, H, W):
    """Every draw ``_augment_jit`` makes from ``key``, as the port's AugParams."""
    k_crop, k_flip, k_rot, k_jit, k_erase = jax.random.split(key, 5)
    flip = (
        jnp.where(jax.random.bernoulli(k_flip, 0.5, (B,)), -1.0, 1.0)
        if plan.horizontal_flip else jnp.ones((B,))
    )
    max_rad = math.radians(plan.rotation_degrees)
    return augment.AugParams(
        crop=_t(_jax_crop_draws(k_crop, plan, H, W)),
        flip=_t(flip),
        thetas=_t(_u(k_rot, lo=-max_rad, hi=max_rad)),
        jitter=_t(_jax_jitter_draws(k_jit, plan)),
        erase=_t(_jax_erase_draws(k_erase, plan)),
    )


@pytest.mark.parametrize("img_size", [32, 72])
def test_crop_window_matches_sample_crop(img_size):
    plan = _plan(img_size)
    H = W = plan.host_canvas_size
    key = jax.random.key(img_size)
    want = np.stack(jax_aug._sample_crop(key, plan, B, H, W), 1)
    got = augment.crop_window(plan, _t(_jax_crop_draws(key, plan, H, W)), H, W)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-5)


def _window(plan, key):
    H = W = plan.host_canvas_size
    return augment.crop_window(plan, _t(_jax_crop_draws(key, plan, H, W)), H, W)


@pytest.mark.parametrize("flip", [1.0, -1.0])
def test_separable_warp_matches_jax(flip):
    plan = _plan(72)
    x = _canvas(plan).astype(np.float32) / 255.0
    window = _window(plan, jax.random.key(1))
    flips = torch.tensor([flip, -flip, flip])
    params = np.concatenate([window.numpy(), np.ones((B, 1)), np.zeros((B, 1)),
                             flips.numpy()[:, None]], 1)
    want = np.asarray(jax_aug._separable_warp(jnp.asarray(x), jnp.asarray(params), 72))
    got = augment.separable_warp(torch.from_numpy(x), window, flips, 72)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_affine_sample_matches_jax():
    plan = _plan(72)
    x = _canvas(plan, 1).astype(np.float32) / 255.0
    window = _window(plan, jax.random.key(2))
    thetas = torch.tensor([0.4, -0.3, 0.05])
    flips = torch.tensor([-1.0, 1.0, 1.0])
    params = np.concatenate([window.numpy(), np.cos(thetas.numpy())[:, None],
                             np.sin(thetas.numpy())[:, None], flips.numpy()[:, None]], 1)
    want = np.asarray(jax.vmap(lambda im, p: jax_aug._affine_sample(im, p, 72))(
        jnp.asarray(x), jnp.asarray(params, jnp.float32)))
    got = augment.affine_sample(torch.from_numpy(x), window, thetas, flips, 72)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_color_jitter_matches_jax():
    plan = _plan(72)
    x = np.random.default_rng(3).random((B, 24, 24, 3)).astype(np.float32)
    key = jax.random.key(3)
    want = np.asarray(jax_aug._color_jitter(jnp.asarray(x), key, plan))
    got = augment.color_jitter(torch.from_numpy(x), _t(_jax_jitter_draws(key, plan)), plan)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=0)


def test_random_erasing_matches_jax():
    plan = _plan(72)
    x = np.random.default_rng(4).normal(size=(B, 40, 40, 3)).astype(np.float32)
    for seed in range(4):
        key = jax.random.key(seed)
        want = np.asarray(jax_aug._random_erasing(jnp.asarray(x), key, plan))
        got = augment.random_erasing(torch.from_numpy(x), _t(_jax_erase_draws(key, plan)), plan)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("img_size,mode,toggles", [
    (72, "shear", {}),
    (72, "gather", {"train_rotation_degrees": 20.0}),
    (72, "none", {"train_random_rotation": False}),
    (32, "shear", {"train_random_rotation": True, "train_color_jitter": True,
                   "train_random_erasing": True}),
])
def test_augment_batch_matches_jax_given_its_draws(monkeypatch, img_size, mode, toggles):
    monkeypatch.setattr(jax_shear, "rotate_batch",
                        functools.partial(jax_shear.rotate_batch, interpret=True))
    plan = _plan(img_size, **toggles)
    assert augment.rotation_mode(plan) == mode
    images = _canvas(plan, img_size)
    key = jax.random.key(11)
    want = np.asarray(jax_aug._augment_jit(jnp.asarray(images), key, plan, jnp.float32, mode))
    params = _jax_params(key, plan, *images.shape[1:3])
    got = augment.apply_augment(torch.from_numpy(images), params, plan)
    assert got.shape == (B, 3, img_size, img_size)
    tol = 2e-2 if mode == "shear" else 5e-4
    np.testing.assert_allclose(got.permute(0, 2, 3, 1).numpy(), want, atol=tol, rtol=0)


def test_rotation_mode_takes_the_shear_on_every_device():
    assert augment.rotation_mode(_plan(224)) == "shear"  # 10 degrees, the recipe's
    assert augment.rotation_mode(_plan(224, train_rotation_degrees=13.7)) == "shear"
    assert augment.rotation_mode(_plan(224, train_rotation_degrees=20.0)) == "gather"
    assert augment.rotation_mode(_plan(32)) == "none"


def test_sampled_parameters_have_the_jax_ranges():
    plan = _plan(224)
    H = W = plan.host_canvas_size
    p = augment.sample_params(torch.Generator().manual_seed(0), plan, 256, H, W)
    assert p.crop.shape == (256, 4) and p.jitter.shape == (256, 4) and p.erase.shape == (256, 5)
    assert p.flip.shape == p.thetas.shape == (256,)
    lo, hi = plan.rrc_scale
    assert lo <= float(p.crop[:, 0].min()) and float(p.crop[:, 0].max()) <= hi
    assert math.log(plan.rrc_ratio[0]) <= float(p.crop[:, 1].min())
    assert float(p.crop[:, 1].max()) <= math.log(plan.rrc_ratio[1])
    assert 0.0 <= float(p.crop[:, 2:].min()) and float(p.crop[:, 2:].max()) < 1.0
    assert set(p.flip.tolist()) == {-1.0, 1.0}
    max_rad = math.radians(plan.rotation_degrees)
    assert float(p.thetas.abs().max()) <= max_rad and float(p.thetas.std()) > max_rad / 3
    for i, s in enumerate(JITTER[:3]):
        assert 1 - s <= float(p.jitter[:, i].min()) and float(p.jitter[:, i].max()) <= 1 + s
    assert float(p.jitter[:, 3].abs().max()) <= JITTER[3]
    assert set(p.erase[:, 0].tolist()) == {0.0, 1.0}
    window = augment.crop_window(plan, p.crop, H, W)
    assert float(window[:, 0].min()) >= 0 and float((window[:, 0] + window[:, 2] * 224).max()) \
        <= H + 1e-3


def test_augment_batch_is_deterministic_per_generator():
    plan = _plan(72)
    images = torch.from_numpy(_canvas(plan, 5))
    a = augment.augment_batch(images, torch.Generator().manual_seed(1), plan, torch.bfloat16)
    b = augment.augment_batch(images, torch.Generator().manual_seed(1), plan, torch.bfloat16)
    c = augment.augment_batch(images, torch.Generator().manual_seed(2), plan, torch.bfloat16)
    assert a.dtype == torch.bfloat16 and a.shape == (B, 3, 72, 72)
    assert a.is_contiguous(memory_format=torch.channels_last)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert not torch.equal(a, c)
