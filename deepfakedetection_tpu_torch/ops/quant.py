"""Opt-in int8 eval for the conv backbones.

Port of ``deepfakedetection_tpu/ops/quant.py``. Under a ``QuantCtx``
(``quantized_eval``), every eligible ConvBN at eval (dense, and depthwise
unless ``include_depthwise`` is off) quantizes its input with a static
symmetric activation scale, its BN-folded weights per output channel, runs
an int8 x int8 -> int32 product and dequantizes in the epilogue
``acc * (sw * sx) + b`` (the product and the sum rounded apart), then its
activation and one cast:

- **activations**: scales from a calibration pass (``calibrate_act_scales``:
  each ConvBN's input absmax, |x| percentile or per-channel absmax over a few
  batches, divided by 127), keyed by the ConvBN's name (its conv's module
  name, ``models/common.name_conv_bns``), or one ``default_scale``;
- **weights**: per-output-channel int8 from the folded f32 weights, with
  per-channel activation scales folded in first (dense and depthwise convs;
  other groupings take the scalar max of the channel scales);
- **products**: dense convs (1x1 and k x k) through ``torch._int_mm``
  (cuBLASLt's s8 x s8 -> s32 GEMM on the card), a k x k conv's patches
  gathered from the padded int8 NHWC tensor by a strided view and one copy,
  K and N padded with zero columns (exact) to what cuBLASLt takes; depthwise
  convs through ``ops/int8_dw.py``'s kernel. The JAX package computes both in
  XLA, outside any Pallas kernel.

Rounding is half-to-even in both frameworks; the quantizing division and
clip are in f32. Scales travel outside the model (a ``contextvars`` variable
holding plain floats or float tuples), so checkpoints and the converters'
name maps are untouched.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from collections.abc import Iterable, Iterator
from dataclasses import dataclass, field

import numpy as np
import torch
import torch.nn.functional as F

from deepfakedetection_tpu_torch.ops.int8_dw import epilogue, int8_depthwise

CALIB_MODES = ("absmax", "percentile", "per-channel")

Pads = tuple[tuple[int, int], tuple[int, int]]
# an activation scale: one float, or one a channel
Scale = float | tuple[float, ...]

_QUANT_CTX: contextvars.ContextVar[QuantCtx | None] = contextvars.ContextVar(
    "dfd_quant_ctx", default=None
)


def as_scale(value) -> Scale:
    """A float for a scalar, a tuple of floats for a [Cin] array."""
    return float(value) if np.ndim(value) == 0 else tuple(float(v) for v in np.ravel(value))


@dataclass(frozen=True)
class QuantCtx:
    """The active int8-eval configuration.

    ``scales`` maps a ConvBN's name to its activation scale (a float, or a
    [Cin] array for per-channel calibration); ``default_scale`` serves layers
    missing from the map (``bench --int8`` runs with a uniform one).
    ``calibrate`` switches the ConvBNs to a full-precision pass that records
    each input's range statistic (``calib_mode``: "absmax", "percentile" at
    ``percentile``, or "per-channel") into ``stats`` instead of quantizing."""

    scales: dict[str, Scale] | None = None
    default_scale: float | None = None
    calibrate: bool = False
    include_depthwise: bool = True
    calib_mode: str = "absmax"
    percentile: float = 0.999
    # name -> the running max of the statistic, on the model's device
    stats: dict[str, torch.Tensor] = field(default_factory=dict, compare=False)

    def __post_init__(self) -> None:
        if self.calib_mode not in CALIB_MODES:
            raise ValueError(f"calib_mode must be one of {CALIB_MODES}, got {self.calib_mode!r}")
        if self.scales is not None:
            object.__setattr__(self, "scales", {k: as_scale(v) for k, v in self.scales.items()})

    def scale_for(self, name: str | None) -> Scale | None:
        if self.scales is not None and name in self.scales:
            return self.scales[name]
        return self.default_scale

    def record(self, name: str | None, stat: torch.Tensor) -> None:
        """Combines a calibration statistic into ``stats`` by the max."""
        if name is None:
            raise ValueError("calibration needs named ConvBNs (models/common.name_conv_bns)")
        prev = self.stats.get(name)
        self.stats[name] = stat if prev is None else torch.maximum(prev, stat)


def current_ctx() -> QuantCtx | None:
    return _QUANT_CTX.get()


@contextlib.contextmanager
def quantized_eval(ctx: QuantCtx) -> Iterator[None]:
    token = _QUANT_CTX.set(ctx)
    try:
        yield
    finally:
        _QUANT_CTX.reset(token)


def quantize_weight_per_channel(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """f32 HWIO weights -> (int8 weights, f32 per-output-channel scale [O])."""
    absmax = w.abs().amax(dim=tuple(range(w.dim() - 1)))
    sw = torch.clamp(absmax, min=1e-8) / 127.0
    wq = torch.clamp(torch.round(w / sw), -127.0, 127.0).to(torch.int8)
    return wq, sw


def _inverse(scale: Scale, device) -> float | torch.Tensor:
    """1 / scale in f32: a float, or an f32 [Cin] tensor on ``device``."""
    if isinstance(scale, float):
        return float(np.float32(1.0) / np.float32(scale))
    return torch.from_numpy(np.float32(1.0) / np.asarray(scale, np.float32)).to(device)


def quantize_act(x: torch.Tensor, scale) -> torch.Tensor:
    """bf16/f32 activations -> int8 with static symmetric scale(s): a float
    (global) or a [Cin] sequence broadcast over the last (channel) dim. The
    clip also realizes percentile calibration: values past the range
    saturate at +-127."""
    return _quantize(x, _inverse(as_scale(scale), x.device))


def _quantize(x: torch.Tensor, inv: float | torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(x.float() * inv), -127.0, 127.0).to(torch.int8)


@dataclass(frozen=True)
class Int8Weights:
    """A conv's int8 operands, derived once per set of weights and scales.
    ``kind`` "dense": ``wq`` [Np, Kp] (the GEMM's B transposed, K = kh kw Cin
    in (kh, kw, c) order, both zero-padded as ``_gemm_operand`` says);
    "grouped": [groups, Np, Kp]; "depthwise": [k, k, C]. ``scale`` [Cout] f32
    is the epilogue's ``sw * sx`` (``sw`` where per-channel activation
    scales were folded into the weights); ``inv`` the f32 inverse of the
    activation scale x is quantized with."""

    kind: str
    wq: torch.Tensor
    scale: torch.Tensor
    bias: torch.Tensor
    inv: float | torch.Tensor
    kernel: tuple[int, int]
    cin: int
    cout: int


def _round_up(n: int, m: int) -> int:
    return -(-n // m) * m


def _gemm_operand(wq: torch.Tensor) -> torch.Tensor:
    """int8 HWIO [kh, kw, ci, co] -> [Np, Kp], the zero-padded transpose of
    its [K, co] matrix: Np a multiple of 16, Kp of 8 and at least 16. On the
    H100 cuBLASLt refused N = 8 mod 16 at K = 0 mod 16 and M past ~65k
    (CUBLAS_STATUS_NOT_SUPPORTED), and needs K and N of at least 16."""
    kh, kw, ci, co = wq.shape
    kp = max(16, _round_up(kh * kw * ci, 8))
    out = torch.zeros((_round_up(co, 16), kp), dtype=torch.int8, device=wq.device)
    out[:co, : kh * kw * ci] = wq.reshape(kh * kw * ci, co).t()
    return out


def prepare(w_folded: torch.Tensor, bias: torch.Tensor, act_scale: Scale,
            groups: int) -> Int8Weights:
    """The int8 operands of a conv with BN-folded f32 HWIO weights and f32
    bias. A per-channel ``act_scale`` folds into the weights of a dense
    (groups 1) or depthwise conv, x_c = xq_c sx_c giving conv(x, w) =
    conv(xq, w sx); other groupings take the scalar max of the channel
    scales."""
    kh, kw, ci, co = w_folded.shape
    cin = ci * groups
    depthwise = groups == cin and ci == 1 and co == cin
    sx = as_scale(act_scale)
    if isinstance(sx, tuple):
        st = torch.tensor(sx, dtype=torch.float32, device=w_folded.device)
        if groups == 1 and ci == cin:
            w_eff = w_folded * st[None, None, :, None]
        elif depthwise:
            w_eff = w_folded * st[None, None, None, :]
        else:
            w_eff, sx = None, float(np.max(np.asarray(sx, np.float32)))
        if w_eff is not None:
            wq, scale = quantize_weight_per_channel(w_eff)
    if isinstance(sx, float):
        wq, sw = quantize_weight_per_channel(w_folded)
        scale = sw * float(np.float32(sx))
    if depthwise:
        kind, operand = "depthwise", wq.reshape(kh, kw, co).contiguous()
    elif groups == 1:
        kind, operand = "dense", _gemm_operand(wq)
    else:
        g = co // groups
        kind = "grouped"
        operand = torch.stack([_gemm_operand(wq[..., i * g:(i + 1) * g]) for i in range(groups)])
    return Int8Weights(kind, operand, scale.contiguous(), bias.float().contiguous(),
                       _inverse(sx, w_folded.device), (kh, kw), cin, co)


def _patches(xq: torch.Tensor, kernel: tuple[int, int], strides: tuple[int, int], pads: Pads,
             kp: int) -> torch.Tensor:
    """The GEMM's A [M, kp] int8 from NHWC int8 xq: every output pixel's
    kh x kw x C window of the zero-padded input as one row, (kh, kw, c)
    order, zero columns past kh kw C. A strided view, then one copy; none for
    a 1x1 stride-1 conv over 8k channels."""
    B, H, W, C = xq.shape
    (kh, kw), (sh, sw) = kernel, strides
    (pt, pb), (pl, pr) = pads
    if (kh, kw, sh, sw, pt, pb, pl, pr) == (1, 1, 1, 1, 0, 0, 0, 0) and C == kp:
        return xq.reshape(B * H * W, C)
    xp = F.pad(xq, (0, 0, pl, pr, pt, pb)) if pt or pb or pl or pr else xq
    Hp, Wp = H + pt + pb, W + pl + pr
    Ho, Wo = (Hp - kh) // sh + 1, (Wp - kw) // sw + 1
    windows = xp.as_strided((B, Ho, Wo, kh, kw, C), (Hp * Wp * C, sh * Wp * C, sw * C, Wp * C, C, 1),
                            xp.storage_offset())
    K = kh * kw * C
    a = torch.empty((B * Ho * Wo, kp), dtype=torch.int8, device=xq.device)
    if kp > K:
        a[:, K:].zero_()
    a[:, :K].unflatten(1, (kh, kw, C)).unflatten(0, (B, Ho, Wo)).copy_(windows)
    return a


def _gemm(a: torch.Tensor, bt: torch.Tensor) -> torch.Tensor:
    """int8 [M, Kp] x the transpose of int8 [Np, Kp] -> int32 [M, Np] by
    ``torch._int_mm``, whose CUDA build takes more than 16 rows: fewer are
    padded with zero rows."""
    m = a.shape[0]
    if m <= 16:
        a = F.pad(a, (0, 0, 0, 32 - m))
    return torch._int_mm(a, bt.t())[:m]


def _dense_acc(xq: torch.Tensor, bt: torch.Tensor, kernel, strides, pads, cout: int):
    B, H, W, _ = xq.shape
    (kh, kw), (sh, sw) = kernel, strides
    (pt, pb), (pl, pr) = pads
    Ho, Wo = (H + pt + pb - kh) // sh + 1, (W + pl + pr - kw) // sw + 1
    acc = _gemm(_patches(xq, kernel, strides, pads, bt.shape[1]), bt)
    return acc[:, :cout].reshape(B, Ho, Wo, cout)


def accumulate(xq: torch.Tensor, qw: Int8Weights, strides: tuple[int, int],
               pads: Pads) -> torch.Tensor:
    """The exact int32 accumulator [B, Ho, Wo, Cout] of the dense or grouped
    int8 conv of NHWC int8 ``xq`` (a depthwise conv's is
    ``int8_dw.int8_depthwise_acc_plain``'s)."""
    pads = tuple(map(tuple, pads))
    if qw.kind == "dense":
        return _dense_acc(xq, qw.wq, qw.kernel, strides, pads, qw.cout)
    if qw.kind != "grouped":
        raise ValueError(f"accumulate: a {qw.kind} conv's accumulator is not a GEMM's")
    groups = qw.wq.shape[0]
    ci, co = qw.cin // groups, qw.cout // groups
    return torch.cat([
        _dense_acc(xq[..., i * ci:(i + 1) * ci].contiguous(), qw.wq[i], qw.kernel, strides,
                   pads, co) for i in range(groups)], dim=-1)


def apply(x: torch.Tensor, qw: Int8Weights, strides: tuple[int, int], pads: Pads, *,
          act: str = "none", out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """NHWC x through the int8 conv: quantize, the int32 product, then
    ``act(acc * scale + bias)`` in f32 and one cast to ``out_dtype``; a
    depthwise conv in one launch of ``int8_depthwise`` on the card."""
    pads = tuple(map(tuple, pads))
    xq = _quantize(x, qw.inv).contiguous()
    if qw.kind == "depthwise":
        if strides[0] != strides[1]:
            raise ValueError(f"int8 depthwise conv: unequal strides {strides}")
        return int8_depthwise(xq, qw.wq, qw.scale, qw.bias, stride=strides[0], pads=pads,
                              act=act, out_dtype=out_dtype)
    return epilogue(accumulate(xq, qw, strides, pads), qw.scale, qw.bias, act, out_dtype)


def int8_conv(x: torch.Tensor, w_folded: torch.Tensor, bias: torch.Tensor, act_scale: Scale,
              strides: tuple[int, int], pads: Pads, groups: int) -> torch.Tensor:
    """Quantized conv of NHWC ``x`` with f32 NHWC output ``acc * (sw * sx) +
    b`` (see ``prepare`` and ``apply``); ``w_folded`` [kh, kw, Cin/groups,
    Cout] and ``bias`` are a ConvBN's BN-folded f32 weights and bias."""
    return apply(x, prepare(w_folded, bias, act_scale, groups), strides, pads)


def _quantile(flat: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.quantile(flat, q)`` (linear interpolation, the position q (n-1)
    computed in f32), from the top (1 - q) share by ``topk``:
    ``torch.quantile`` refuses inputs past 2^24 elements."""
    n = flat.numel()
    pos = np.float32(q) * (np.float32(n) - np.float32(1.0))
    lo, hi = min(max(math.floor(pos), 0), n - 1), min(max(math.ceil(pos), 0), n - 1)
    hw = np.float32(pos - np.float32(lo))
    top = torch.topk(flat, n - lo, sorted=False).values
    low2 = torch.topk(top, min(2, top.numel()), largest=False, sorted=True).values
    return low2[0] * float(np.float32(1.0) - hw) + low2[hi - lo] * float(hw)


def range_stat(x: torch.Tensor, mode: str, percentile: float = 0.999) -> torch.Tensor:
    """The calibration statistic of NHWC ``x``: the global absmax, the
    global |x| quantile at ``percentile``, or the per-channel absmax [C]."""
    ax = x.float().abs()
    if mode == "percentile":
        return _quantile(ax.reshape(-1), percentile)
    if mode == "per-channel":
        return ax.amax(dim=tuple(range(ax.dim() - 1)))
    return ax.amax()


def collect_calibration_absmax(stats: dict[str, torch.Tensor]) -> dict[str, float | np.ndarray]:
    """A calibration pass's statistics on the host: {name: float} for the
    scalar modes, {name: [Cin] float64 array} per channel."""
    out: dict[str, float | np.ndarray] = {}
    for name, stat in stats.items():
        val = stat.detach().cpu().double().numpy()
        out[name] = float(val) if val.ndim == 0 else val
    return out


@torch.no_grad()
def calibrate_act_scales(model: torch.nn.Module, batches: Iterable[torch.Tensor], *,
                         include_depthwise: bool = True, mode: str = "absmax",
                         percentile: float = 0.999) -> dict[str, float | np.ndarray]:
    """Run the model (at eval) over ``batches`` (normalized NCHW images),
    recording each eligible ConvBN's input statistic (``range_stat``),
    combined by the max over calls and batches -> activation scales
    ``max(stat, 1e-6) / 127``: floats, or [Cin] arrays per channel."""
    ctx = QuantCtx(calibrate=True, include_depthwise=include_depthwise, calib_mode=mode,
                   percentile=percentile)
    with quantized_eval(ctx):
        for images in batches:
            model(images)
    return {
        name: max(val, 1e-6) / 127.0 if np.ndim(val) == 0 else np.maximum(val, 1e-6) / 127.0
        for name, val in collect_calibration_absmax(ctx.stats).items()
    }
