"""EfficientNet (B0-B7) in PyTorch, bf16 compute.

Port of ``deepfakedetection_tpu/models/efficientnet.py``. Module names are
efficientnet_pytorch's (``_conv_stem``, ``_blocks.N._expand_conv`` ...), so a
reference ``.pth`` loads with ``strict=True``. Activations are NCHW-logical
and stored channels_last.

Training (``model.train()``): every ConvBN takes its batch statistics (see
``models/common.py``), residual branches drop per sample at rate
``drop_connect_rate * block_index / blocks``, and the head applies dropout on
the f32 pooled features. The masks come from the generator passed to
``forward``; a training forward with a nonzero rate needs one. The fused
kernels K1 and K2 serve eval only, as in the JAX package.

MBConv dispatch at eval in bf16, for stride 1, k in {3, 5}, symmetric pads
and SiLU: a block with an expansion runs expand + depthwise + SE mean as one
K2 launch (``ops/expand_dw.py``); a block without one runs its depthwise
ConvBN through K1 (``ops/depthwise_se.py``). The wrappers launch the CUDA
kernels for CUDA tensors and run their plain versions for CPU tensors, so the
dispatch is the same on every device. The stem, the stride-2 depthwise convs,
project, SE and head are cuDNN convolutions, as XLA computes them outside any
Pallas kernel in the JAX package. In float32 the eligible blocks run the
unfused f32 ConvBN chain, which is what the JAX package's default path
computes.

With ``DFD_FUSED_MBCONV`` set when the model is built (``runtime/flags``), a
bf16 eval block that K2 would serve and that has a residual (in == out) runs
whole through K3 (``ops/fused_mbconv.py``): expand, depthwise, SE, gate,
project, bias and residual, on the BN-folded weights, packed into the
kernels' layouts once per set of parameters. The JAX package has no
model route to its K3; under the switch the SE runs in f32 with
bf16-rounded weights (bf16 on the unfused path), the gate product is rounded
to bf16, and project, bias and residual are rounded once.

Under an int8 ``QuantCtx`` (``ops/quant.py``: calibration or the int8 eval)
K1, K2 and K3 are bypassed, as the JAX package bypasses its K2, so that every
ConvBN sees its own input; the depthwise convs then run through the int8
depthwise kernel (``ops/int8_dw.py``).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch import nn

from deepfakedetection_tpu_torch.models.common import (
    ConvBN,
    Derived,
    DropPath,
    Pads,
    SqueezeExcite,
    dropout,
    make_divisible,
    name_conv_bns,
    nhwc,
    symmetric_pad,
)
from deepfakedetection_tpu_torch.ops import quant
from deepfakedetection_tpu_torch.ops.expand_dw import expand_dw_silu_pool
from deepfakedetection_tpu_torch.ops.fused_mbconv import fused_mbconv_se, pack
from deepfakedetection_tpu_torch.runtime.flags import fused_mbconv

# (expand_ratio, channels, repeats, stride, kernel) - base (B0) stages
_BASE_BLOCKS = (
    (1, 16, 1, 1, 3),
    (6, 24, 2, 2, 3),
    (6, 40, 2, 2, 5),
    (6, 80, 3, 2, 3),
    (6, 112, 3, 1, 5),
    (6, 192, 4, 2, 5),
    (6, 320, 1, 1, 3),
)

# width, depth, native resolution, dropout
_VARIANTS: dict[str, tuple[float, float, int, float]] = {
    "b0": (1.0, 1.0, 224, 0.2),
    "b1": (1.0, 1.1, 240, 0.2),
    "b2": (1.1, 1.2, 260, 0.3),
    "b3": (1.2, 1.4, 300, 0.3),
    "b4": (1.4, 1.8, 380, 0.4),
    "b5": (1.6, 2.2, 456, 0.4),
    "b6": (1.8, 2.6, 528, 0.5),
    "b7": (2.0, 3.1, 600, 0.5),
}

_BN_MOMENTUM = 0.01  # torch convention for the JAX package's decay 0.99
_BN_EPSILON = 1e-3


def static_same_pads(size: int, kernel: int, stride: int) -> Pads:
    """TF-SAME padding frozen from a trace at ``size`` (efficientnet_pytorch
    Conv2dStaticSamePadding): at 224, B3's two k5/stride-2 depthwise convs pad
    (2, 2), not (1, 2)."""
    out = -(-size // stride)
    total = max((out - 1) * stride + kernel - size, 0)
    return ((total // 2, total - total // 2),) * 2


@dataclass(frozen=True)
class BlockArgs:
    in_features: int
    out_features: int
    expand_ratio: int
    kernel: int
    stride: int
    se_ratio: float
    drop_rate: float
    dw_pads: Pads


def _bn(c: int) -> nn.BatchNorm2d:
    return nn.BatchNorm2d(c, eps=_BN_EPSILON, momentum=_BN_MOMENTUM)


class MBConv(nn.Module):
    """Mobile inverted bottleneck with squeeze-excitation."""

    def __init__(self, args: BlockArgs, *, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        a = self.args = args
        self.dtype = dtype
        mid = a.in_features * a.expand_ratio
        self.has_expand = a.expand_ratio != 1
        if self.has_expand:
            self._expand_conv = nn.Conv2d(a.in_features, mid, 1, bias=False)
            self._bn0 = _bn(mid)
            self.expand = ConvBN(self._expand_conv, self._bn0, act=F.silu, dtype=dtype)
        self._depthwise_conv = nn.Conv2d(
            mid, mid, a.kernel, stride=a.stride, groups=mid, bias=False
        )
        self._bn1 = _bn(mid)
        self.depthwise = ConvBN(
            self._depthwise_conv, self._bn1, pads=a.dw_pads, act=F.silu, dtype=dtype
        )
        # SE reduction is sized from the block INPUT channels (efficientnet_pytorch)
        se_features = max(1, int(a.in_features * a.se_ratio))
        self._se_reduce = nn.Conv2d(mid, se_features, 1)
        self._se_expand = nn.Conv2d(se_features, mid, 1)
        self.se = SqueezeExcite(self._se_reduce, self._se_expand, dtype=dtype)
        self._project_conv = nn.Conv2d(mid, a.out_features, 1, bias=False)
        self._bn2 = _bn(a.out_features)
        self.project = ConvBN(self._project_conv, self._bn2, dtype=dtype)
        self.residual = a.stride == 1 and a.in_features == a.out_features
        self.drop_path = DropPath(a.drop_rate)
        self.whole_block = fused_mbconv()  # DFD_FUSED_MBCONV, read at build
        self._k3_operands = Derived(self._gather_k3_operands)
        self._k3_packed = Derived(self._pack_k3_operands)

    def fused(self) -> str | None:
        """Which kernel serves this block at eval: "k3", "k2", "k1" or None
        (None under an int8 ``QuantCtx``, which runs every ConvBN on its own
        input)."""
        a = self.args
        if (
            self.training
            or quant.current_ctx() is not None
            or self.dtype != torch.bfloat16
            or a.stride != 1
            or a.kernel not in (3, 5)
            or not symmetric_pad(a.dw_pads, a.kernel)
        ):
            return None
        if not self.has_expand:
            return "k1"
        return "k3" if self.whole_block and self.residual else "k2"

    def _k3_tensors(self) -> list[torch.Tensor]:
        return (self.expand._params() + self.depthwise._params() + self.project._params()
                + self.se._tensors())

    def _gather_k3_operands(self) -> tuple[torch.Tensor, ...]:
        """K3's operands in the JAX layout: the folded expand [C, Cmid],
        depthwise [k, k, Cmid] and project [Cmid, C] with their biases, and
        the SE FCs as [Cmid, Cse] and [Cse, Cmid] with theirs."""
        k = self.args.kernel
        w_exp, b_exp = self.expand(None, fold_only=True)  # [1, 1, C, Cmid]
        w_dw, b_dw = self.depthwise(None, fold_only=True)  # [k, k, 1, Cmid]
        w_proj, b_proj = self.project(None, fold_only=True)  # [1, 1, Cmid, C]
        cse, mid = self._se_reduce.weight.shape[:2]
        return (
            w_exp.view(w_exp.shape[2], mid), b_exp, w_dw.view(k, k, mid), b_dw,
            self._se_reduce.weight.view(cse, mid).t().contiguous(), self._se_reduce.bias.detach(),
            self._se_expand.weight.view(mid, cse).t().contiguous(), self._se_expand.bias.detach(),
            w_proj.view(mid, w_proj.shape[3]), b_proj,
        )

    def _pack_k3_operands(self):
        """K3's weights in its kernels' layouts (``ops/fused_mbconv.pack``),
        packed on the card once per set of parameters; None on the CPU."""
        ops = self._k3_operands.get(self._k3_tensors())
        return pack(ops[0], ops[6], ops[8]) if ops[0].is_cuda else None

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        served = self.fused()
        if served == "k3":  # drop path is the identity at eval
            tensors = self._k3_tensors()
            y = fused_mbconv_se(
                nhwc(x.to(self.dtype)),
                *self._k3_operands.get(tensors),
                kernel=self.args.kernel,
                packed=self._k3_packed.get(tensors),
            )
            return y.permute(0, 3, 1, 2)
        shortcut = x
        if served == "k2":
            k = self.args.kernel
            wexp, bexp = self.expand(None, fold_only=True)  # [1, 1, Cin, Ce]
            wdw, bdw = self.depthwise(None, fold_only=True)  # [k, k, 1, Ce]
            y, se_mean = expand_dw_silu_pool(
                nhwc(x.to(self.dtype)),
                wexp.view(wexp.shape[2], wexp.shape[3]),
                bexp,
                wdw.view(k, k, -1),
                bdw,
                kernel=k,
            )
            x = y.permute(0, 3, 1, 2)
        else:
            if self.has_expand:
                x = self.expand(x)
            x, se_mean = self.depthwise(x, return_spatial_mean=True)
        x = self.se(x, pooled=se_mean)
        x = self.project(x)
        if self.residual:
            x = self.drop_path(x, generator) + shortcut
        return x


class EfficientNet(nn.Module):
    """EfficientNet classifier over normalized NCHW-logical images; returns
    f32 logits. ``native_resolution`` is the variant's training size, from
    which the static-SAME pads are frozen (300 for B3)."""

    def __init__(
        self,
        num_classes: int,
        width_coefficient: float = 1.2,
        depth_coefficient: float = 1.4,
        dropout_rate: float = 0.3,
        drop_connect_rate: float = 0.2,
        se_ratio: float = 0.25,
        native_resolution: int = 300,
        dtype: torch.dtype = torch.bfloat16,
        generator: torch.Generator | None = None,
    ) -> None:
        super().__init__()
        self.dtype = dtype
        self.dropout_rate = dropout_rate
        self.width_coefficient = width_coefficient
        self.depth_coefficient = depth_coefficient
        trace = native_resolution
        stem = self.round_filters(32)
        self._conv_stem = nn.Conv2d(3, stem, 3, stride=2, bias=False)
        self._bn0 = _bn(stem)
        self.stem = ConvBN(
            self._conv_stem, self._bn0, pads=static_same_pads(trace, 3, 2), act=F.silu,
            dtype=dtype,
        )
        trace = -(-trace // 2)
        total = sum(self.round_repeats(r) for _, _, r, _, _ in _BASE_BLOCKS)
        blocks = []
        in_features = stem
        for expand, channels, repeats, stride, kernel in _BASE_BLOCKS:
            out_features = self.round_filters(channels)
            for rep in range(self.round_repeats(repeats)):
                s = stride if rep == 0 else 1
                args = BlockArgs(
                    in_features=in_features,
                    out_features=out_features,
                    expand_ratio=expand,
                    kernel=kernel,
                    stride=s,
                    se_ratio=se_ratio,
                    drop_rate=drop_connect_rate * len(blocks) / max(total, 1),
                    dw_pads=static_same_pads(trace, kernel, s),
                )
                if s > 1:
                    trace = -(-trace // s)
                blocks.append(MBConv(args, dtype=dtype))
                in_features = out_features
        self._blocks = nn.ModuleList(blocks)
        head = self.round_filters(1280)
        self._conv_head = nn.Conv2d(in_features, head, 1, bias=False)
        self._bn1 = _bn(head)
        self.head = ConvBN(self._conv_head, self._bn1, act=F.silu, dtype=dtype)
        self._fc = nn.Linear(head, num_classes)
        name_conv_bns(self)
        if generator is not None:
            self.reset_parameters(generator)

    def round_filters(self, filters: int) -> int:
        return make_divisible(filters * self.width_coefficient, 8)

    def round_repeats(self, repeats: int) -> int:
        return int(math.ceil(self.depth_coefficient * repeats))

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init: convs N(0, 2/fan_in), which keeps activations near unit
        scale through the depth at eval with identity BatchNorm, the classifier
        U(-1/sqrt(fan_in), 1/sqrt(fan_in)), zero biases and identity
        BatchNorm. Draws on the CPU from ``generator``."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                w = torch.randn(m.weight.shape, generator=generator) * math.sqrt(2.0 / fan_in)
                m.weight.copy_(w)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Linear):
                bound = 1.0 / math.sqrt(m.in_features)
                m.weight.copy_(torch.rand(m.weight.shape, generator=generator) * 2 * bound - bound)
                m.bias.zero_()
            elif isinstance(m, nn.BatchNorm2d):
                m.reset_parameters()

    def kernel_launches_per_forward(self) -> dict[str, int]:
        """How many blocks K1, K2 and K3 serve in one eval forward."""
        served = [b.fused() for b in self._blocks]
        return {k: served.count(k) for k in ("k1", "k2", "k3")}

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """f32 logits. ``generator`` (on x's device) draws the drop-path and
        dropout masks of a training forward."""
        return self.classify(self.cam_features(x, generator), generator)

    def cam_features(self, x: torch.Tensor,
                     generator: torch.Generator | None = None) -> torch.Tensor:
        """The head ConvBN's [B, C, H, W] map in the compute dtype (the JAX
        model's ``cam_features``)."""
        x = x.to(self.dtype).contiguous(memory_format=torch.channels_last)
        x = self.stem(x)
        for block in self._blocks:
            x = block(x, generator)
        return self.head(x)

    def classify(self, feats: torch.Tensor,
                 generator: torch.Generator | None = None) -> torch.Tensor:
        """f32 logits of the map: its f32 mean pool (dropout in training)
        through ``_fc``."""
        x = feats.float().mean(dim=(2, 3))
        if self.training and self.dropout_rate > 0.0:
            x = dropout(x, self.dropout_rate, generator)
        return self._fc(x)


def create_efficientnet(
    variant: str = "b3",
    *,
    num_classes: int = 2,
    dtype: torch.dtype = torch.bfloat16,
    generator: torch.Generator | None = None,
    dropout_rate: float | None = None,
    drop_connect_rate: float = 0.2,
) -> EfficientNet:
    """The variant at its published widths; ``dropout_rate`` defaults to
    the variant's (0.3 for B3)."""
    if variant not in _VARIANTS:
        raise KeyError(f"unknown EfficientNet variant '{variant}'")
    width, depth, res, variant_dropout = _VARIANTS[variant]
    return EfficientNet(
        num_classes=num_classes,
        width_coefficient=width,
        depth_coefficient=depth,
        dropout_rate=variant_dropout if dropout_rate is None else dropout_rate,
        drop_connect_rate=drop_connect_rate,
        native_resolution=res,
        dtype=dtype,
        generator=generator,
    )
