"""Input normalisation and the training augmentation, on the device.

Port of ``deepfakedetection_tpu/data/augment.py``. The host only decodes
each image to a square uint8 canvas; crop, flip, rotation, color jitter,
normalisation and random erasing run on the batch's device.

Each augmentation is split in two: sampling (``sample_params``, every random
draw, from a ``torch.Generator`` on the batch's device) and applying
(``apply_augment`` and its parts, deterministic given the parameters). The
parameters are the values the JAX package's ``_augment_jit`` draws, so the
tests hand both frameworks the same ones.

Geometry, as the JAX package's accelerator path: an axis-aligned crop,
resize and flip is two batched matmuls against triangle-filter matrices
(``separable_warp``). Rotation up to 13.7 degrees runs on the canvas first,
through the three-shear kernel K4 (``ops/shear_rotate.py``) on every device:
the CUDA kernel on the card, its plain version on the CPU. The JAX package
takes that path only on a TPU and the gather warp on its CPU; the port takes
it everywhere so the CPU tests run the card's samples (``PERF.md``, "shear on
every device"). Larger angles compose crop, flip and rotation into one
bilinear gather (``affine_sample``). Order: geometry, jitter (brightness,
contrast, saturation, hue), normalise, erasing.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, fields

import torch

from deepfakedetection_tpu_torch.data.transforms import EvalTransformPlan, TrainTransformPlan
from deepfakedetection_tpu_torch.ops.shear_rotate import rotate_batch
from deepfakedetection_tpu_torch.parallel import mesh

# the shear kernel's validity bound for the rotation range, in degrees
SHEAR_MAX_DEG = 13.7

_GRAY = (0.2989, 0.587, 0.114)
_TO_YIQ = ((0.299, 0.587, 0.114), (0.5959, -0.2746, -0.3213), (0.2115, -0.5227, 0.3112))


def _to_unit(images: torch.Tensor) -> torch.Tensor:
    x = images.float()
    if not images.dtype.is_floating_point:
        x = x * (1.0 / 255.0)
    return x


def _normalize(x: torch.Tensor, plan, channel_dim: int) -> torch.Tensor:
    shape = [1] * x.dim()
    shape[channel_dim] = 3
    mean = torch.tensor(plan.mean, dtype=torch.float32, device=x.device).view(shape)
    std = torch.tensor(plan.std, dtype=torch.float32, device=x.device).view(shape)
    return (x - mean) / std


def normalize_batch(
    images: torch.Tensor, plan: EvalTransformPlan, out_dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """uint8 [B,S,S,3] -> ``(x/255 - mean) / std`` (ImageNet statistics) in
    ``out_dtype``, computed in f32 on the tensor's device. Returns the
    NCHW-logical view of the NHWC data, which is channels_last in memory."""
    x = _to_unit(images.permute(0, 3, 1, 2))
    if plan.normalize:
        x = _normalize(x, plan, 1)
    return x.to(out_dtype)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class AugParams:
    """One batch's draws, f32 tensors on the batch's device.

    ``crop`` [B,4]: ``crop_window``'s draws (random crop: ty, tx; random
    resized crop: area fraction, log aspect ratio, and two uniforms that place
    the window). ``flip`` [B]: -1 mirrors. ``thetas`` [B]: radians.
    ``jitter`` [B,4]: brightness, contrast and saturation factors, and the hue
    shift as a fraction of a turn. ``erase`` [B,5]: apply (0 or 1), area
    fraction, log aspect ratio, and two uniforms that place the rectangle."""

    crop: torch.Tensor
    flip: torch.Tensor
    thetas: torch.Tensor
    jitter: torch.Tensor
    erase: torch.Tensor


def sample_params(
    generator: torch.Generator, plan: TrainTransformPlan, B: int, H: int, W: int
) -> AugParams:
    """Every random draw of one batch over [B, H, W, 3] canvases, from
    ``generator`` on its device, with the JAX package's distributions."""
    device = generator.device

    def uniform(lo: float, hi: float, *shape: int) -> torch.Tensor:
        u = torch.rand(*shape, generator=generator, device=device)
        return lo + (hi - lo) * u

    S = plan.img_size
    if plan.small_images:
        crop = torch.stack([
            torch.randint(0, max(H - S, 0) + 1, (B,), generator=generator, device=device),
            torch.randint(0, max(W - S, 0) + 1, (B,), generator=generator, device=device),
        ], 1).float()
        crop = torch.cat([crop, torch.zeros_like(crop)], 1)
    else:
        crop = torch.stack([
            uniform(*plan.rrc_scale, B),
            uniform(math.log(plan.rrc_ratio[0]), math.log(plan.rrc_ratio[1]), B),
            uniform(0.0, 1.0, B),
            uniform(0.0, 1.0, B),
        ], 1)
    flip = torch.where(uniform(0.0, 1.0, B) < 0.5, -1.0, 1.0)
    if not plan.horizontal_flip:
        flip = torch.ones_like(flip)
    max_rad = math.radians(plan.rotation_degrees)
    thetas = uniform(-max_rad, max_rad, B)
    b, c, s, h = plan.jitter
    jitter = torch.stack([
        uniform(max(0.0, 1 - b), 1 + b, B),
        uniform(max(0.0, 1 - c), 1 + c, B),
        uniform(max(0.0, 1 - s), 1 + s, B),
        uniform(-h, h, B),
    ], 1)
    erase = torch.stack([
        (uniform(0.0, 1.0, B) < plan.erasing_p).float(),
        uniform(*plan.erasing_scale, B),
        uniform(math.log(plan.erasing_ratio[0]), math.log(plan.erasing_ratio[1]), B),
        uniform(0.0, 1.0, B),
        uniform(0.0, 1.0, B),
    ], 1)
    return AugParams(crop=crop, flip=flip, thetas=thetas, jitter=jitter, erase=erase)


def crop_window(plan: TrainTransformPlan, draws: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """[B,4] (ty, tx, sy, sx): the crop window in canvas pixels and its
    canvas pixels per output pixel, from ``AugParams.crop`` (the JAX
    package's ``_sample_crop``)."""
    S = plan.img_size
    B = draws.shape[0]
    one = torch.ones(B, device=draws.device)
    if plan.small_images:
        if plan.random_crop:
            ty, tx = draws[:, 0], draws[:, 1]
        elif plan.center_crop:
            ty = torch.full((B,), float((H - S) // 2), device=draws.device)
            tx = torch.full((B,), float((W - S) // 2), device=draws.device)
        else:
            ty = tx = torch.zeros(B, device=draws.device)
        return torch.stack([ty, tx, one, one], 1)
    if plan.random_resized_crop:
        # oversize candidates clamp instead of torchvision's 10 tries (PARITY delta 5)
        area = float(H * W) * draws[:, 0]
        ratio = torch.exp(draws[:, 1])
        cw = torch.clamp(torch.sqrt(area * ratio), max=float(W))
        ch = torch.clamp(torch.sqrt(area / ratio), max=float(H))
        ty = draws[:, 2] * (H - ch)
        tx = draws[:, 3] * (W - cw)
        return torch.stack([ty, tx, ch / S, cw / S], 1)
    ty = torch.full((B,), (H - S) / 2.0, device=draws.device)
    tx = torch.full((B,), (W - S) / 2.0, device=draws.device)
    return torch.stack([ty, tx, one, one], 1)


# ---------------------------------------------------------------------------
# applying
# ---------------------------------------------------------------------------


def _axis_weights(centers: torch.Tensor, scale: torch.Tensor, size: int) -> torch.Tensor:
    """[B, out, size] triangle-filter rows around ``centers`` [B, out]; the
    support widens with ``scale`` [B, 1] on a downscale (antialiasing)."""
    support = torch.clamp(scale, min=1.0)[:, :, None]
    src = torch.arange(size, dtype=torch.float32, device=centers.device)[None, None, :]
    w = torch.clamp(1.0 - (src - centers[:, :, None]).abs() / support, min=0.0)
    return w / torch.clamp(w.sum(-1, keepdim=True), min=1e-8)


def _output_grid(window: torch.Tensor, flip: torch.Tensor, out_size: int):
    """Source-space sample centres [B, out] along y and x of the crop window,
    the x order reversed where ``flip`` < 0."""
    ty, tx, sy, sx = window.unbind(1)
    o = torch.arange(out_size, dtype=torch.float32, device=window.device)[None, :]
    xo = torch.where(flip[:, None] > 0, o, out_size - 1 - o)
    yc = ty[:, None] + (o + 0.5) * sy[:, None] - 0.5
    xc = tx[:, None] + (xo + 0.5) * sx[:, None] - 0.5
    return yc, xc


def separable_warp(
    imgs: torch.Tensor, window: torch.Tensor, flip: torch.Tensor, out_size: int
) -> torch.Tensor:
    """Axis-aligned crop, resize and flip of [B,H,W,C] f32 as two batched
    matmuls -> [B, out, out, C]."""
    _, H, W, _ = imgs.shape
    yc, xc = _output_grid(window, flip, out_size)
    wy = _axis_weights(yc, window[:, 2:3], H)
    wx = _axis_weights(xc, window[:, 3:4], W)
    tmp = torch.einsum("boh,bhwc->bowc", wy, imgs)
    return torch.einsum("bpw,bowc->bopc", wx, tmp)


def affine_sample(
    imgs: torch.Tensor, window: torch.Tensor, thetas: torch.Tensor, flip: torch.Tensor,
    out_size: int,
) -> torch.Tensor:
    """Crop, flip and rotation about the canvas centre composed into one
    bilinear gather per output pixel, zero fill outside: [B,H,W,C] f32 ->
    [B, out, out, C]."""
    B, H, W, C = imgs.shape
    ycrop, xcrop = _output_grid(window, flip, out_size)
    cos, sin = torch.cos(thetas)[:, None, None], torch.sin(thetas)[:, None, None]
    cy, cx = (H - 1) / 2.0, (W - 1) / 2.0
    u = xcrop[:, None, :] - cx
    v = ycrop[:, :, None] - cy
    xs = cx + cos * u + sin * v
    ys = cy - sin * u + cos * v
    x0, y0 = torch.floor(xs), torch.floor(ys)
    fx, fy = xs - x0, ys - y0
    bidx = torch.arange(B, device=imgs.device)[:, None, None]

    def tap(yi, xi, wgt):
        inb = (yi >= 0) & (yi < H) & (xi >= 0) & (xi < W)
        vals = imgs[bidx, yi.clamp(0, H - 1).long(), xi.clamp(0, W - 1).long()]
        return vals * (wgt * inb)[..., None]

    return (
        tap(y0, x0, (1 - fy) * (1 - fx))
        + tap(y0, x0 + 1, (1 - fy) * fx)
        + tap(y0 + 1, x0, fy * (1 - fx))
        + tap(y0 + 1, x0 + 1, fy * fx)
    )


def color_jitter(x: torch.Tensor, jitter: torch.Tensor, plan: TrainTransformPlan) -> torch.Tensor:
    """Brightness, contrast, saturation, hue in that fixed order (PARITY
    delta 4) on [B,S,S,3] floats in [0, 1]; hue is a rotation in YIQ."""
    b, c, s, h = plan.jitter
    B = x.shape[0]
    w = torch.tensor(_GRAY, dtype=torch.float32, device=x.device)

    def gray(img):
        return (img * w).sum(-1, keepdim=True)

    if b > 0:
        x = torch.clamp(x * jitter[:, 0].view(B, 1, 1, 1), 0.0, 1.0)
    if c > 0:
        m = gray(x).mean(dim=(1, 2), keepdim=True)
        x = torch.clamp((x - m) * jitter[:, 1].view(B, 1, 1, 1) + m, 0.0, 1.0)
    if s > 0:
        g = gray(x)
        x = torch.clamp((x - g) * jitter[:, 2].view(B, 1, 1, 1) + g, 0.0, 1.0)
    if h > 0:
        fh = jitter[:, 3] * 2.0 * math.pi
        to_yiq = torch.tensor(_TO_YIQ, dtype=torch.float32, device=x.device)
        from_yiq = torch.linalg.inv(to_yiq)
        yiq = torch.einsum("bhwc,dc->bhwd", x, to_yiq)
        cos_h, sin_h = torch.cos(fh)[:, None, None], torch.sin(fh)[:, None, None]
        i, q = yiq[..., 1], yiq[..., 2]
        yiq = torch.stack([yiq[..., 0], i * cos_h - q * sin_h, i * sin_h + q * cos_h], -1)
        x = torch.clamp(torch.einsum("bhwd,cd->bhwc", yiq, from_yiq), 0.0, 1.0)
    return x


def random_erasing(x: torch.Tensor, erase: torch.Tensor, plan: TrainTransformPlan) -> torch.Tensor:
    """torchvision RandomErasing(value=0) on normalised [B,S,S,C]; the
    rectangle clamps to the image instead of retrying."""
    S = x.shape[1]
    area = float(S * S) * erase[:, 1]
    ratio = torch.exp(erase[:, 2])
    he = torch.clamp(torch.round(torch.sqrt(area * ratio)), max=float(S))
    we = torch.clamp(torch.round(torch.sqrt(area / ratio)), max=float(S))
    top = torch.floor(erase[:, 3] * (S - he + 1))
    left = torch.floor(erase[:, 4] * (S - we + 1))
    rows = torch.arange(S, dtype=torch.float32, device=x.device)[None, :, None]
    cols = torch.arange(S, dtype=torch.float32, device=x.device)[None, None, :]

    def col(t):
        return t[:, None, None]

    inside = (
        (rows >= col(top)) & (rows < col(top + he))
        & (cols >= col(left)) & (cols < col(left + we))
    )
    erased = inside & (col(erase[:, 0]) > 0.5)
    return torch.where(erased[..., None], 0.0, x)


def rotation_mode(plan: TrainTransformPlan) -> str:
    """"shear" (K4) up to 13.7 degrees on every device, "gather" above,
    "none" without rotation."""
    if not plan.rotation:
        return "none"
    return "shear" if plan.rotation_degrees <= SHEAR_MAX_DEG else "gather"


def apply_augment(
    images: torch.Tensor, params: AugParams, plan: TrainTransformPlan,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """uint8 [B,H,W,3] canvases -> normalised [B, 3, S, S] ``out_dtype``,
    NCHW-logical and channels_last in memory, given the draws."""
    mode = rotation_mode(plan)
    _, H, W, _ = images.shape
    S = plan.img_size
    x = _to_unit(images)
    window = crop_window(plan, params.crop, H, W)
    if mode == "shear":
        # bf16 planes through the three passes, as the JAX package does
        x = rotate_batch(
            x.to(torch.bfloat16).contiguous(), params.thetas,
            max_theta=math.radians(plan.rotation_degrees),
        ).float()
        x = separable_warp(x, window, params.flip, S)
    elif mode == "gather":
        x = affine_sample(x, window, params.thetas, params.flip, S)
    else:
        x = separable_warp(x, window, params.flip, S)
    if plan.color_jitter:
        x = color_jitter(x, params.jitter, plan)
    if plan.normalize:
        x = _normalize(x, plan, 3)
    if plan.random_erasing:
        x = random_erasing(x, params.erase, plan)
    return x.permute(0, 3, 1, 2).to(out_dtype)


def augment_batch(
    images: torch.Tensor, generator: torch.Generator, plan: TrainTransformPlan,
    out_dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """The training augmentation of one batch: draws from ``generator`` (on
    the images' device), then ``apply_augment``. Deterministic per
    generator state. Under a process group the draws are made for the
    global batch and this rank applies its rows of them
    (``mesh.global_rows``), so the ranks' batches together are the one
    process's batch."""
    B, H, W, _ = images.shape
    rows = mesh.global_rows(B)
    if rows is None:
        params = sample_params(generator, plan, B, H, W)
    else:
        total, start = rows
        drawn = sample_params(generator, plan, total, H, W)
        params = AugParams(**{f.name: getattr(drawn, f.name)[start : start + B]
                              for f in fields(AugParams)})
    return apply_augment(images, params, plan, out_dtype=out_dtype)
