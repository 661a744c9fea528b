"""EfficientFormerV2 (S0/S1/S2/L) in PyTorch, bf16 compute: the eval forward.

Port of ``deepfakedetection_tpu/models/efficientformer_v2.py``: a stem of two
3x3 stride-2 ConvBN + GELU, four stages of unified-FFN blocks (1x1 expand ->
3x3 depthwise -> 1x1 project, BN after each conv, layer scale), the last two
blocks of stages 3 and 4 with talking-head attention before their FFN (stage
3's at half resolution: a stride-2 depthwise conv down, bilinear back up), an
attention-assisted downsample into stages 3 and 4, the final BatchNorm, an
f32 mean pool and the averaged ``head`` / ``head_dist`` pair. Activations are
NCHW-logical tensors stored channels_last.

Module names are timm's (``stem.conv1``, ``stages.{s}.downsample.{conv,
attn}``, ``stages.{s}.blocks.{b}.{token_mixer,ls1,mlp,ls2}``, ``norm``,
``head``, ``head_dist``; a ConvNorm is ``.conv`` + ``.bn``), so a timm state
dict loads strictly. Two forms of it load alike: with the attention's output
projection spelled ``proj.1`` (the ``Sequential(act, ConvNorm)`` of older
timm and ``tests/torch_refs/efficientformer_v2_torch.py``) or ``proj`` (the
port's), and with or without conv biases in the ConvNorms (timm's own builds
have them; the JAX package's tree has none): a ConvNorm's conv takes a bias
exactly when the loaded dict has one, and ``ConvBN`` folds it into the BN.

Eval numerics are the JAX package's bf16 ones: ConvBN folded in f32 with one
cast after the activation, GELU in its tanh form (``common.gelu``), layer
scale multiplied in the compute dtype. Attention4D follows the JAX model's
kernel branch, K7 (``ops/attn4d.py``) in bf16: its bf16 output is added to
the local-v branch in f32 and cast again (the JAX CPU path, the XLA einsums,
rounds once). float32 models attend in plain f32 ops. The attention-assisted
downsample is plain attention (no talking heads, 196 x 784 and 49 x 196
tokens at 224 px) in PyTorch ops, as the JAX package leaves it to XLA.

In training (``model.train()``) it follows the JAX ``train=True`` path: every
ConvNorm with batch statistics and its running-statistic update at decay 0.9
(``ConvBN``'s train numerics), the final ``norm`` through ``batch_norm_train``,
and Attention4D through ``attn4d_plain`` at the JAX XLA branch's rounding (the
f32 output summed with the local-v branch before one cast), as the JAX
package never takes its kernel in training; the bias tables, talking heads and
the query's local conv are read from their parameters on every call, so their
gradients flow. There is no drop path (the JAX builder fixes its rate at 0).

``cam_features`` returns the Grad-CAM map, the final norm's output in the
compute dtype (the JAX model's ``cam_features``); ``forward`` is ``classify``
of it.
"""

from __future__ import annotations

import functools
import math
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deepfakedetection_tpu_torch.models.common import (
    ConvBN,
    Derived,
    batch_norm_train,
    gelu,
    name_conv_bns,
    nhwc,
)
from deepfakedetection_tpu_torch.ops.attn4d import attn4d, attn4d_plain
from deepfakedetection_tpu_torch.ops.window_attn import _heads, _merge, _probs

_VARIANTS: dict[str, dict[str, Any]] = {
    "s0": {"dims": (32, 48, 96, 176), "depths": (2, 2, 6, 4), "vit_num": 2,
           "e_ratios": {0: [4, 4], 1: [4, 4], 2: [4, 3, 3, 3, 4, 4], 3: [4, 3, 3, 4]}},
    "s1": {"dims": (32, 48, 120, 224), "depths": (3, 3, 9, 6), "vit_num": 2,
           "e_ratios": {0: [4, 4, 4], 1: [4, 4, 4], 2: [4, 4, 3, 3, 3, 3, 4, 4, 4],
                        3: [4, 4, 3, 3, 4, 4]}},
    "s2": {"dims": (32, 64, 144, 288), "depths": (4, 4, 12, 8), "vit_num": 4,
           "e_ratios": {0: [4, 4, 4, 4], 1: [4, 4, 4, 4],
                        2: [4, 4, 3, 3, 3, 3, 3, 3, 3, 3, 4, 4], 3: [4, 4, 3, 3, 3, 3, 4, 4]}},
    "l": {"dims": (40, 80, 192, 384), "depths": (5, 5, 15, 10), "vit_num": 6,
          "e_ratios": {0: [4, 4, 4, 4, 4], 1: [4, 4, 4, 4, 4],
                       2: [4, 4, 4, 3, 3, 3, 3, 3, 3, 3, 3, 3, 4, 4, 4],
                       3: [4, 4, 4, 3, 3, 3, 3, 4, 4, 4]}},
}
_LAYER_SCALE_INIT = 1e-5


def bias_index(q_res: int, k_res: int, stride: int = 1) -> np.ndarray:
    """[q_res², k_res²] slots of the learned bias table, timm's encoding:
    |stride·qy - ky|·k_res + |stride·qx - kx| over row-major token grids (the
    attention's own grid at stride 1, the downsample's query grid against its
    key grid at stride 2)."""
    qy, qx = np.divmod(np.arange(q_res * q_res), q_res)
    ky, kx = np.divmod(np.arange(k_res * k_res), k_res)
    dy = np.abs(stride * qy[:, None] - ky[None, :])
    dx = np.abs(stride * qx[:, None] - kx[None, :])
    return (dy * k_res + dx).astype(np.int64)


def _tokens(x: torch.Tensor) -> torch.Tensor:
    """[B, C, H, W] -> [B, H*W, C] (a view of a channels_last map, through
    ``nhwc``, so that a tracer's fake map gives K7 a unit feature stride too)."""
    B, C, H, W = x.shape
    return nhwc(x).reshape(B, H * W, C)


def _map(t: torch.Tensor, H: int, W: int) -> torch.Tensor:
    """[B, H*W, C] -> [B, C, H, W], stored channels_last."""
    B, _, C = t.shape
    return t.reshape(B, H, W, C).permute(0, 3, 1, 2)


class ConvNorm(nn.Module):
    """timm's ConvNorm (``conv`` + ``bn``) run as a ``ConvBN``: a k x k conv
    with symmetric padding k // 2, BN folded in f32 at eval, then ``act``. The
    conv carries a bias exactly when the state dict it loads has one."""

    def __init__(self, cin: int, cout: int, k: int = 1, stride: int = 1, groups: int = 1, *,
                 act=None, dtype: torch.dtype) -> None:
        super().__init__()
        self.conv = nn.Conv2d(cin, cout, k, stride, groups=groups, bias=False)
        self.bn = nn.BatchNorm2d(cout)
        r = k // 2
        self.cb = ConvBN(self.conv, self.bn, pads=((r, r), (r, r)), act=act, dtype=dtype)
        self.register_load_state_dict_pre_hook(ConvNorm._conv_bias_of)

    @staticmethod
    def _conv_bias_of(module: ConvNorm, state_dict, prefix, *_) -> None:
        conv = module.conv
        has = prefix + "conv.bias" in state_dict
        if has != (conv.bias is not None):
            conv.bias = (nn.Parameter(torch.zeros(conv.out_channels, device=conv.weight.device))
                         if has else None)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.cb(x)


def _proj_alias(module: nn.Module, state_dict, prefix, *_) -> None:
    """Reads the ``proj.1.*`` spelling of the output projection as ``proj.*``."""
    old = prefix + "proj.1."
    for key in [k for k in state_dict if k.startswith(old)]:
        state_dict[prefix + "proj." + key[len(old):]] = state_dict.pop(key)


class LayerScale2d(nn.Module):
    """Per-channel ``gamma``, multiplied in x's dtype."""

    def __init__(self, dim: int) -> None:
        super().__init__()
        self.gamma = nn.Parameter(torch.full((dim,), _LAYER_SCALE_INIT))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * self.gamma.to(x.dtype).view(1, -1, 1, 1)


class ConvMlpWithNorm(nn.Module):
    """The unified FFN: 1x1 expand + GELU, 3x3 depthwise + GELU, 1x1 project."""

    def __init__(self, dim: int, hidden: int, *, dtype: torch.dtype) -> None:
        super().__init__()
        self.fc1 = ConvNorm(dim, hidden, act=gelu, dtype=dtype)
        self.mid = ConvNorm(hidden, hidden, 3, groups=hidden, act=gelu, dtype=dtype)
        self.fc2 = ConvNorm(hidden, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.mid(self.fc1(x)))


class Attention2d(nn.Module):
    """Attention4D: q, k, v 1x1 ConvNorms, a depthwise local-v branch, a
    learned per-offset bias, talking heads across the heads before and after
    the softmax (K7), GELU and the output ConvNorm. ``stride`` 2 attends on a
    map pooled by a stride-2 depthwise ConvNorm and upsamples the result
    bilinearly (half-pixel centres, edges clamped) before GELU."""

    def __init__(self, dim: int, resolution: int, stride: int | None = None, *, key_dim: int = 32,
                 num_heads: int = 8, attn_ratio: int = 4, dtype: torch.dtype) -> None:
        super().__init__()
        self.num_heads, self.dtype, self.stride = num_heads, dtype, stride
        self.scale = key_dim**-0.5
        self.dh = int(attn_ratio * key_dim) * num_heads
        if stride is not None:
            self.stride_conv = ConvNorm(dim, dim, 3, stride, groups=dim, dtype=dtype)
            resolution = math.ceil(resolution / stride)
        self.resolution = resolution
        self.q = ConvNorm(dim, key_dim * num_heads, dtype=dtype)
        self.k = ConvNorm(dim, key_dim * num_heads, dtype=dtype)
        self.v = ConvNorm(dim, self.dh, dtype=dtype)
        self.v_local = ConvNorm(self.dh, self.dh, 3, groups=self.dh, dtype=dtype)
        self.talking_head1 = nn.Conv2d(num_heads, num_heads, 1)
        self.talking_head2 = nn.Conv2d(num_heads, num_heads, 1)
        self.proj = ConvNorm(self.dh, dim, dtype=dtype)
        self.attention_biases = nn.Parameter(torch.zeros(num_heads, resolution * resolution))
        self.register_buffer("attention_bias_idxs",
                             torch.from_numpy(bias_index(resolution, resolution)), persistent=False)
        self._tables = Derived(self._gather)
        self.register_load_state_dict_pre_hook(_proj_alias)

    def uses_kernel(self) -> bool:
        return self.dtype == torch.bfloat16

    def _sources(self) -> list[torch.Tensor]:
        t1, t2 = self.talking_head1, self.talking_head2
        return [self.attention_biases, t1.weight, t1.bias, t2.weight, t2.bias]

    def _gather(self) -> tuple[torch.Tensor, ...]:
        """K7's f32 tables: the gathered bias [h, N, N], and each talking head
        as the flax [h_in, g_out] table (the conv's [g, h, 1, 1] weight
        transposed) and its bias."""
        h = self.num_heads
        bias = self.attention_biases[:, self.attention_bias_idxs].float().contiguous()
        out = [bias]
        for th in (self.talking_head1, self.talking_head2):
            out += [th.weight.float().view(h, h).t().contiguous(), th.bias.float().contiguous()]
        return tuple(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, _, H0, W0 = x.shape
        if self.stride is not None:
            x = self.stride_conv(x)
        H, W = x.shape[2:]
        if (H, W) != (self.resolution, self.resolution):
            raise ValueError(f"Attention4D built for {self.resolution}x{self.resolution}, got "
                             f"{H}x{W}: build the model at the input's img_size")
        v = self.v(x)
        v_local = self.v_local(v)
        if self.training:
            tables, attend = self._gather(), functools.partial(attn4d_plain,
                                                               out_dtype=torch.float32)
        else:
            tables = self._tables.get(self._sources())
            attend = attn4d if self.uses_kernel() else attn4d_plain
        out = attend(_tokens(self.q(x)), _tokens(self.k(x)), _tokens(v), *tables,
                     num_heads=self.num_heads, scale=self.scale)
        out = (_map(out, H, W).float() + v_local.float()).to(self.dtype)
        if self.stride is not None:
            out = F.interpolate(out, size=(H0, W0), mode="bilinear", align_corners=False)
        return self.proj(gelu(out))


class LocalGlobalQuery(nn.Module):
    """The downsample's query: x subsampled by 2 plus a 3x3 stride-2
    depthwise conv of x with a bias and no BN (rounded to the compute dtype,
    then its bias added in it), then a 1x1 ConvNorm."""

    def __init__(self, cin: int, cout: int, *, dtype: torch.dtype) -> None:
        super().__init__()
        self.dtype = dtype
        self.local = nn.Conv2d(cin, cin, 3, 2, 1, groups=cin)
        self.proj = ConvNorm(cin, cout, dtype=dtype)
        # the weight rounded to the compute dtype, taken by the conv as f32
        # (exact products, f32 accumulation), and the bias in the compute
        # dtype: cached at eval, cast on every call in training
        self._local = Derived(self._cast)

    def _cast(self) -> tuple[torch.Tensor, torch.Tensor]:
        return (self.local.weight.to(self.dtype).float().contiguous(
            memory_format=torch.channels_last), self.local.bias.to(self.dtype).view(1, -1, 1, 1))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = (self._cast() if self.training
                else self._local.get([self.local.weight, self.local.bias]))
        local = F.conv2d(x.float(), w, None, 2, 1, 1, self.local.groups).to(self.dtype) + b
        return self.proj(x[:, :, ::2, ::2] + local)


class Attention2dDownsample(nn.Module):
    """The attention branch of the stage-3 and stage-4 downsamples: plain
    multi-head attention (8 heads, key_dim 16) from the half-resolution query
    grid onto the full-resolution key grid with a learned per-offset bias,
    plus a stride-2 depthwise local-v branch, GELU and a 1x1 ConvNorm."""

    def __init__(self, dim: int, out_dim: int, resolution: int, *, key_dim: int = 16,
                 num_heads: int = 8, attn_ratio: int = 4, dtype: torch.dtype) -> None:
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.scale = key_dim**-0.5
        self.dh = int(attn_ratio * key_dim) * num_heads
        self.resolution = resolution
        self.q = LocalGlobalQuery(dim, key_dim * num_heads, dtype=dtype)
        self.k = ConvNorm(dim, key_dim * num_heads, dtype=dtype)
        self.v = ConvNorm(dim, self.dh, dtype=dtype)
        self.v_local = ConvNorm(self.dh, self.dh, 3, 2, groups=self.dh, dtype=dtype)
        self.proj = ConvNorm(self.dh, out_dim, dtype=dtype)
        self.attention_biases = nn.Parameter(torch.zeros(num_heads, resolution * resolution))
        self.register_buffer("attention_bias_idxs",
                             torch.from_numpy(bias_index(resolution // 2, resolution, stride=2)),
                             persistent=False)
        self._bias = Derived(self._gather)
        self.register_load_state_dict_pre_hook(_proj_alias)

    def _gather(self) -> torch.Tensor:
        return self.attention_biases[:, self.attention_bias_idxs].float()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        B, _, H, W = x.shape
        if (H, W) != (self.resolution, self.resolution) or H % 2:
            raise ValueError(f"attention downsample built for {self.resolution}x"
                             f"{self.resolution} (even), got {H}x{W}")
        h = self.num_heads
        q = _heads(_tokens(self.q(x)), h)
        k = _heads(_tokens(self.k(x)), h)
        v = self.v(x)
        v_local = self.v_local(v)
        bias = self._gather() if self.training else self._bias.get([self.attention_biases])
        p = _probs(q, k, bias, self.scale).to(self.dtype)
        out = _merge(p.float() @ _heads(_tokens(v), h).float())
        out = (_map(out, H // 2, W // 2) + v_local.float()).to(self.dtype)
        return self.proj(gelu(out))


class Downsample(nn.Module):
    """A 3x3 stride-2 ConvNorm, plus the attention branch into stages 3-4."""

    def __init__(self, cin: int, cout: int, resolution: int, *, use_attn: bool,
                 dtype: torch.dtype) -> None:
        super().__init__()
        self.conv = ConvNorm(cin, cout, 3, 2, dtype=dtype)
        if use_attn:
            self.attn = Attention2dDownsample(cin, cout, resolution, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv(x)
        return self.attn(x) + out if hasattr(self, "attn") else out


class Block(nn.Module):
    """x + ls1·attn(x) where the block attends, then x + ls2·mlp(x)."""

    def __init__(self, dim: int, mlp_ratio: float, resolution: int, *, stride: int | None,
                 use_attn: bool, dtype: torch.dtype) -> None:
        super().__init__()
        if use_attn:
            self.token_mixer = Attention2d(dim, resolution, stride, dtype=dtype)
            self.ls1 = LayerScale2d(dim)
        self.mlp = ConvMlpWithNorm(dim, int(dim * mlp_ratio), dtype=dtype)
        self.ls2 = LayerScale2d(dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if hasattr(self, "token_mixer"):
            x = x + self.ls1(self.token_mixer(x))
        return x + self.ls2(self.mlp(x))


class EfficientFormerV2(nn.Module):
    """EfficientFormerV2 classifier over normalized NCHW-logical images at
    ``img_size`` (the attention bias tables' sizes depend on it: 7x7 tokens
    at 224 px); returns f32 logits, the mean of ``head`` and ``head_dist``."""

    def __init__(
        self,
        num_classes: int,
        dims: tuple[int, ...] = (32, 48, 120, 224),
        depths: tuple[int, ...] = (3, 3, 9, 6),
        vit_num: int = 2,
        e_ratios: dict[int, list[int]] | None = None,
        *,
        img_size: int = 224,
        dtype: torch.dtype = torch.bfloat16,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()
        self.dtype = dtype
        e_ratios = e_ratios or _VARIANTS["s1"]["e_ratios"]
        self.stem = nn.Module()
        self.stem.conv1 = ConvNorm(3, dims[0] // 2, 3, 2, act=gelu, dtype=dtype)
        self.stem.conv2 = ConvNorm(dims[0] // 2, dims[0], 3, 2, act=gelu, dtype=dtype)
        res = math.ceil(math.ceil(img_size / 2) / 2)
        self.stages = nn.ModuleList()
        for s in range(4):
            stage = nn.Module()
            if s > 0:
                stage.downsample = Downsample(dims[s - 1], dims[s], res, use_attn=s >= 2,
                                              dtype=dtype)
                res = math.ceil(res / 2)
            stage.blocks = nn.ModuleList(
                Block(dims[s], e_ratios[s][b], res, stride=2 if s == 2 else None,
                      use_attn=s >= 2 and b > depths[s] - 1 - vit_num, dtype=dtype)
                for b in range(depths[s]))
            self.stages.append(stage)
        self.norm = nn.BatchNorm2d(dims[-1])
        self.head = nn.Linear(dims[-1], num_classes)
        self.head_dist = nn.Linear(dims[-1], num_classes)
        name_conv_bns(self)
        if generator is not None:
            self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init, drawn on the CPU from ``generator``: convs N(0,
        2/fan_in), linear weights N(0, 0.02²), zero biases and bias tables,
        identity norms, layer scale 1e-5."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                               * math.sqrt(2.0 / fan_in))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Linear):
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * 0.02)
                m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()
            elif isinstance(m, LayerScale2d):
                m.gamma.fill_(_LAYER_SCALE_INIT)
            elif isinstance(m, (Attention2d, Attention2dDownsample)):
                m.attention_biases.zero_()

    def attentions(self) -> list[Attention2d]:
        return [m for m in self.modules() if isinstance(m, Attention2d)]

    def kernel_launches_per_forward(self) -> dict[str, int]:
        """K7 launches of one eval forward: every Attention4D in bf16 (4 for
        S1: the last two blocks of stages 3 and 4)."""
        return {"k7": sum(a.uses_kernel() for a in self.attentions())}

    def cam_features(self, x: torch.Tensor,
                     generator: torch.Generator | None = None) -> torch.Tensor:
        """The final norm's [B, C, H, W] map in the compute dtype (the JAX
        model's ``cam_features``). ``generator`` is unused: the model has no
        dropout or drop path."""
        dt = self.dtype
        x = x.to(dt).contiguous(memory_format=torch.channels_last)
        x = self.stem.conv2(self.stem.conv1(x))
        for stage in self.stages:
            if hasattr(stage, "downsample"):
                x = stage.downsample(x)
            for blk in stage.blocks:
                x = blk(x)
        n = self.norm
        if n.training:
            return batch_norm_train(n, x.permute(0, 2, 3, 1)).to(dt).permute(0, 3, 1, 2)
        y = (x.float() - n.running_mean.view(1, -1, 1, 1)) * torch.rsqrt(
            n.running_var + n.eps).view(1, -1, 1, 1) * n.weight.view(1, -1, 1, 1) \
            + n.bias.view(1, -1, 1, 1)
        return y.to(dt)

    def classify(self, feats: torch.Tensor) -> torch.Tensor:
        """f32 logits of the map: its f32 mean pool through the mean of
        ``head`` and ``head_dist``."""
        y = feats.float().mean(dim=(2, 3))
        return (self.head(y) + self.head_dist(y)) / 2.0

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        return self.classify(self.cam_features(x, generator))


def create_efficientformer_v2(
    variant: str = "s1",
    *,
    num_classes: int = 2,
    dtype: torch.dtype = torch.bfloat16,
    generator: torch.Generator | None = None,
    img_size: int = 224,
) -> EfficientFormerV2:
    """The variant at its published widths, built for ``img_size``."""
    if variant not in _VARIANTS:
        raise KeyError(f"unknown EfficientFormerV2 variant '{variant}'")
    cfg = _VARIANTS[variant]
    return EfficientFormerV2(num_classes, cfg["dims"], cfg["depths"], cfg["vit_num"],
                             cfg["e_ratios"], img_size=img_size, dtype=dtype, generator=generator)
