"""FasterViT (0-4) in PyTorch, bf16 compute: the eval and train forwards.

Port of ``deepfakedetection_tpu/models/fastervit.py``: a conv stem (two 3x3
stride-2 ConvBN + ReLU), two stages of residual conv blocks, then two stages
of transformer blocks. Stage 3 runs Hierarchical ATtention over 7x7 windows:
per-window carrier tokens (CTs) from a pooling tokenizer attend among
themselves, then join their window's 49 tokens for a 53-token window
attention. Stage 4 is one window of global attention over its whole map
(7x7 at 224 px, 14x14 = 196 tokens at 448). A model is built for an
``img_size``: where stage 3's map is one window or less (``img_size // 16 <=
window_size``, say 112 or 64 px) stage 3 runs ``PlainBlock``s over its
tokens and builds no carrier-token modules, as the JAX model's degenerate
branch does. Activations are NCHW-logical and stored channels_last outside
the transformer stages.

Two head configurations, as in the JAX package:

- ``"official"``: the fastervit wheel's model (head counts (2, 4, 8, 16),
  head_dim 48 for FasterViT-2; log-CPB relative-bias MLPs zero-padded over the
  carrier-token rows and columns; absolute-position MLPs; carrier tokens
  attended grid-major; the conv tokenizer; conv biases; no layer scale; no CT
  propagation). Module names are the wheel's (``patch_embed.conv_down.*``,
  ``levels.{i}.blocks.{b}.*``, ``levels.2.global_tokenizer.*``, ``norm``,
  ``head``), so a wheel ``.pth`` loads with ``strict=True``.
- ``"tpu"``: head_dim 128 (``tpu_heads``), learned relative-bias tables and
  position tables, layer scale, CT propagation after the last stage-3 block.
  Its own tensors are ``*.attn.rel_bias``, ``*.gamma*``,
  ``levels.2.ct_pos_embed``, ``levels.2.win_pos_embed`` and
  ``levels.3.pos_embed_table``.

``TokenAttention`` keeps the JAX package's split: K5 (``ops/window_attn.py``)
for N >= 32 in bf16, which is the 53-token window attention of every stage-3
block and the 49-token attention of every stage-4 block at 224 px (past 128
tokens, the stage-4 attention at 448 px, the wrapper launches K5's long
kernels); plain PyTorch ops for the 16-token carrier-token attention and for
float32 models. The K5 wrapper launches the CUDA kernel for CUDA tensors and
runs its plain version for CPU tensors. The JAX package takes its kernel only for head_dim % 128 != 0
at eval (a v5e measurement); the port takes K5 in both configurations.

``DFD_FUSED_ATTN`` set when a bf16 model is built (the JAX package's opt-in)
sends every attention, the carrier tokens' included, through K6
(``ops/attn_block.py``): the qkv Linear, the attention and the proj Linear
as one kernel, 21 launches per FasterViT-2 forward and no K5. K6 takes at
most 128 tokens: with the flag, a bf16 model with a longer attention is
refused when it is built (``K6_LONG_ITEM``). ``qkv`` and ``proj`` stay
``Linear`` modules, so the parameters' names and shapes do not change with
the flag; K6 takes their f32 tensors (their cached bf16 weights at eval), so
their gradients come back in f32. The JAX package takes K6 only
where it takes K5 (``use_pallas_for``); the port in both configurations, at
eval and in training. A float32 model with the flag attends through plain
ops, unfused.

In training (``model.train()``, ``forward(x, generator)``) it follows the JAX
package's ``train=True`` path: the conv stages' ConvBN with batch statistics
(decay 0.9), the final ``norm`` through ``batch_norm_train``, the position
MLPs recomputed every call, drop-path after the layer scale on every residual
branch (per window in the window sub-block, per image elsewhere) at the JAX
per-block rate, and K5 through its autograd Function, whose backward is the
K5 backward kernel (K6's Function and backward kernels under the flag).
"""

from __future__ import annotations

import math
from functools import cache
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from deepfakedetection_tpu_torch.models.common import (
    ConvBN,
    Derived,
    DropPath,
    LayerNorm,
    Linear,
    Mlp,
    batch_norm_train,
    gelu,
    name_conv_bns,
    remat,
)
from deepfakedetection_tpu_torch.ops import attn_block
from deepfakedetection_tpu_torch.ops.attn_block import attn_subblock
from deepfakedetection_tpu_torch.ops.window_attn import (
    MAX_TOKENS,
    window_attention,
    window_attention_plain,
)
from deepfakedetection_tpu_torch.runtime.flags import fused_attn

# torch Conv2d(k=3, s=2, padding=1): symmetric, unlike TF-SAME on even inputs
_PAD1 = ((1, 1), (1, 1))
_LAYER_SCALE_INIT = 1e-5
_KERNEL_MIN_TOKENS = 32  # the JAX package's TokenAttention threshold for its kernel
K6_LONG_ITEM = "ROADMAP Queue 1 item 15 (K6 past 128 tokens)"

_VARIANTS: dict[str, dict[str, Any]] = {
    "0": {"dim": 64, "in_dim": 64, "depths": (2, 3, 6, 5), "num_heads": (2, 4, 8, 16)},
    "1": {"dim": 80, "in_dim": 32, "depths": (1, 3, 8, 5), "num_heads": (2, 4, 8, 16)},
    "2": {"dim": 96, "in_dim": 64, "depths": (3, 3, 8, 5), "num_heads": (2, 4, 8, 16)},
    "3": {"dim": 128, "in_dim": 64, "depths": (3, 3, 12, 5), "num_heads": (2, 4, 8, 16)},
    "4": {"dim": 196, "in_dim": 64, "depths": (3, 3, 12, 5), "num_heads": (4, 8, 16, 32)},
}


def tpu_heads(dim: int, official: tuple[int, ...]) -> tuple[int, ...]:
    """The "tpu" configuration's head counts: head_dim 128 where the stage
    width divides, else the nearest smaller divisor, else the official count."""
    heads = []
    for stage in range(len(official)):
        stage_dim = dim * (2**stage)
        h = max(stage_dim // 128, 1)
        while h > 1 and stage_dim % h:
            h -= 1
        if stage_dim % h:
            h = official[stage]
        heads.append(h)
    return tuple(heads)


def stage3_resolution(img_size: int) -> int:
    """The stage-3 map's side: the stem's two stride-2 convs and two
    downsamples, each ceil(n / 2)."""
    res = img_size
    for _ in range(4):
        res = (res + 1) // 2
    return res


def longest_attention(img_size: int, window_size: int = 7, ct_size: int = 2) -> int:
    """The most tokens any attention of a FasterViT built for ``img_size``
    takes: stage 3's carrier-token and window attentions (or its plain
    blocks' map where it is one window or less) and stage 4's map."""
    res3 = stage3_resolution(img_size)
    if res3 > window_size:
        stage3 = max(ct_size**2 + window_size**2, (ct_size * (res3 // window_size)) ** 2)
    else:
        stage3 = res3**2
    return max(stage3, ((res3 + 1) // 2) ** 2)


def k6_refusal(img_size: int, window_size: int = 7, ct_size: int = 2) -> str | None:
    """Why ``DFD_FUSED_ATTN`` cannot run a bf16 FasterViT built for
    ``img_size`` (an attention past K6's tokens), or None."""
    longest = longest_attention(img_size, window_size, ct_size)
    if longest <= attn_block.MAX_TOKENS:
        return None
    return (f"FasterViT at img_size {img_size}: DFD_FUSED_ATTN sends every attention through "
            f"K6, which takes at most {attn_block.MAX_TOKENS} tokens, and this model attends "
            f"over {longest}; K6 past 128 tokens is {K6_LONG_ITEM}. Unset DFD_FUSED_ATTN to "
            f"run it through K5")


def window_partition(x: torch.Tensor, win: int) -> torch.Tensor:
    """[B, C, H, W] -> [B*nW, win*win, C], windows and tokens row-major."""
    B, C, H, W = x.shape
    x = x.reshape(B, C, H // win, win, W // win, win).permute(0, 2, 4, 3, 5, 1)
    return x.reshape(B * (H // win) * (W // win), win * win, C)


def window_reverse(x: torch.Tensor, win: int, H: int, W: int, B: int) -> torch.Tensor:
    """Inverse of window_partition: [B*nW, win*win, C] -> [B, C, H, W],
    channels_last."""
    C = x.shape[-1]
    x = x.reshape(B, H // win, W // win, win, win, C).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(B, H, W, C).permute(0, 3, 1, 2)


def ct_dewindow(ct: torch.Tensor, n_win: int, cs: int) -> torch.Tensor:
    """Window-major carrier tokens [B, n_win²·cs², C], ordered (wy, wx, iy,
    ix), -> grid row-major (y = wy·cs + iy, x = wx·cs + ix)."""
    B, N, C = ct.shape
    return ct.reshape(B, n_win, n_win, cs, cs, C).permute(0, 1, 3, 2, 4, 5).reshape(B, N, C)


def ct_window(ct: torch.Tensor, n_win: int, cs: int) -> torch.Tensor:
    """Inverse of ct_dewindow (grid row-major -> window-major)."""
    B, N, C = ct.shape
    return ct.reshape(B, n_win, cs, n_win, cs, C).permute(0, 1, 3, 2, 4, 5).reshape(B, N, C)


@cache
def _abs_grid_coords(s: int) -> np.ndarray:
    """[s², 2] row-major grid coords normalized by s//2 (PosEmbMLPSwinv1D)."""
    c = (np.arange(s, dtype=np.float32) - s // 2) / max(s // 2, 1)
    yy, xx = np.meshgrid(c, c, indexing="ij")
    return np.stack([yy, xx], axis=-1).reshape(-1, 2)


@cache
def _rel_coords_log(h: int, w: int) -> np.ndarray:
    """[(2h-1)(2w-1), 2] log-scaled relative coords (PosEmbMLPSwinv2D)."""
    ch = np.arange(-(h - 1), h, dtype=np.float32) / max(h - 1, 1)
    cw = np.arange(-(w - 1), w, dtype=np.float32) / max(w - 1, 1)
    yy, xx = np.meshgrid(ch, cw, indexing="ij")
    t = np.stack([yy, xx], axis=-1) * 8.0
    t = np.sign(t) * np.log2(np.abs(t) + 1.0) / np.log2(8.0)
    return t.reshape(-1, 2).astype(np.float32)


@cache
def _rel_position_index(h: int, w: int) -> np.ndarray:
    """[h·w, h·w] swin-style relative-position index into the coords table."""
    coords = np.stack(np.meshgrid(np.arange(h), np.arange(w), indexing="ij"), 0).reshape(2, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += h - 1
    rel[:, :, 1] += w - 1
    rel[:, :, 0] *= 2 * w - 1
    return rel.sum(-1).astype(np.int64)


def _cpb_mlp(out_features: int) -> nn.Sequential:
    """The wheel's ``cpb_mlp``: Linear(2, 512) -> ReLU -> Linear(512, out), f32."""
    return nn.Sequential(nn.Linear(2, 512), nn.ReLU(), nn.Linear(512, out_features, bias=False))


class _Cached(nn.Module):
    """A module whose output depends on its parameters only: computed in f32
    on every call in training, once per parameter change at eval."""

    def __init__(self) -> None:
        super().__init__()
        self._value = Derived(self.compute)

    def compute(self) -> torch.Tensor:
        raise NotImplementedError

    def value(self) -> torch.Tensor:
        if self.training:
            return self.compute()
        return self._value.get([*self.parameters(), *self.buffers()])


class AbsPosMLP(_Cached):
    """PosEmbMLPSwinv1D: x + MLP(grid coords), the MLP 2 -> 512 -> dim in f32,
    added in x's dtype."""

    def __init__(self, dim: int, grid: int) -> None:
        super().__init__()
        self.cpb_mlp = _cpb_mlp(dim)
        self.register_buffer("coords", torch.tensor(_abs_grid_coords(grid)),
                             persistent=False)

    def compute(self) -> torch.Tensor:
        return self.cpb_mlp(self.coords)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x + self.value().to(x.dtype)


class RelPosBiasMLP(_Cached):
    """PosEmbMLPSwinv2D: 16·sigmoid(MLP(log-scaled relative coords)) gathered
    to [h, N, N], zero-padded over the ``n_global`` leading (carrier-token)
    rows and columns, f32."""

    def __init__(self, num_heads: int, window: int, n_global: int = 0) -> None:
        super().__init__()
        self.n_global = n_global
        self.cpb_mlp = _cpb_mlp(num_heads)
        self.register_buffer("table", torch.tensor(_rel_coords_log(window, window)),
                             persistent=False)
        self.register_buffer("index", torch.tensor(_rel_position_index(window, window)),
                             persistent=False)

    def compute(self) -> torch.Tensor:
        bias = 16.0 * torch.sigmoid(self.cpb_mlp(self.table)[self.index])  # [N, N, h]
        bias = bias.permute(2, 0, 1)
        g = self.n_global
        return F.pad(bias, (g, 0, g, 0)).contiguous()


class TokenAttention(nn.Module):
    """Multi-head self-attention over [B, N, C] with a per-head [N, N] bias:
    the official configuration's log-CPB MLP (``pos_emb_funct``) or the tpu
    configuration's learned table (``rel_bias``). Built in bf16 with
    ``DFD_FUSED_ATTN`` set, the whole sub-block runs as K6."""

    def __init__(self, dim: int, num_heads: int, tokens: int, *, window: int, n_global: int,
                 official: bool, dtype: torch.dtype) -> None:
        super().__init__()
        self.num_heads, self.dtype = num_heads, dtype
        self.fused = dtype == torch.bfloat16 and fused_attn()
        self.scale = (dim // num_heads) ** -0.5
        self.qkv = Linear(dim, 3 * dim, dtype=dtype)
        self.proj = Linear(dim, dim, dtype=dtype)
        if official:
            self.pos_emb_funct = RelPosBiasMLP(num_heads, window, n_global)
        else:
            self.rel_bias = nn.Parameter(torch.zeros(num_heads, tokens, tokens))

    def kernel(self, tokens: int) -> str | None:
        """The kernel this attention launches over ``tokens`` tokens on the
        card: "k6", "k5", "k5_long" (past ``MAX_TOKENS``) or None (plain ops)."""
        if self.fused:
            return "k6"
        if self.dtype != torch.bfloat16 or tokens < _KERNEL_MIN_TOKENS:
            return None
        return "k5_long" if tokens > MAX_TOKENS else "k5"

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = self.pos_emb_funct.value() if hasattr(self, "pos_emb_funct") else self.rel_bias
        if self.fused:
            wqkv, wproj = ((self.qkv.weight, self.proj.weight) if self.training
                           else (self.qkv.cast()[0], self.proj.cast()[0]))
            return attn_subblock(x.to(self.dtype), wqkv, self.qkv.bias, bias, wproj,
                                 self.proj.bias, num_heads=self.num_heads, scale=self.scale)
        qkv = self.qkv(x)
        on_k5 = self.kernel(x.shape[1]) in ("k5", "k5_long")  # the wrapper picks the long one
        attend = window_attention if on_k5 else window_attention_plain
        return self.proj(attend(qkv, bias, num_heads=self.num_heads, scale=self.scale))


def _add_subblock(owner: nn.Module, prefix: str, dim: int, num_heads: int, tokens: int, *,
                  window: int, n_global: int, official: bool, mlp_ratio: float,
                  dtype: torch.dtype) -> None:
    """Registers a pre-norm attention + MLP pair on ``owner`` under the wheel's
    flat names (``norm1``, ``attn``, ``norm2``, ``mlp``; ``hat_`` before each
    for the carrier tokens'), with the tpu configuration's ``gamma1/2``."""
    setattr(owner, f"{prefix}norm1", LayerNorm(dim, 1e-5, dtype=dtype))
    setattr(owner, f"{prefix}attn", TokenAttention(
        dim, num_heads, tokens, window=window, n_global=n_global, official=official, dtype=dtype))
    setattr(owner, f"{prefix}norm2", LayerNorm(dim, 1e-5, dtype=dtype))
    setattr(owner, f"{prefix}mlp", Mlp(dim, int(dim * mlp_ratio), dtype=dtype))
    if not official:
        for name in ("gamma1", "gamma2"):
            setattr(owner, f"{prefix}{name}",
                    nn.Parameter(torch.full((dim,), _LAYER_SCALE_INIT)))


def _run_subblock(owner: nn.Module, prefix: str, x: torch.Tensor,
                  generator: torch.Generator | None = None) -> torch.Tensor:
    """The JAX package's TransformerSubBlock: x + dp(γ1·attn(norm1(x))), then
    x + dp(γ2·mlp(norm2(x))), γ in x's dtype (no γ in the official model), dp
    the owner's drop-path (the identity at eval), one mask per row of x."""
    for norm, branch, gamma in (("norm1", "attn", "gamma1"), ("norm2", "mlp", "gamma2")):
        fx = getattr(owner, prefix + branch)(getattr(owner, prefix + norm)(x))
        g = getattr(owner, prefix + gamma, None)
        x = x + owner.drop_path(fx if g is None else fx * g.to(fx.dtype), generator)
    return x


class ConvBlock(nn.Module):
    """Stages 1-2: x + dp(γ·BN(conv(GELU(BN(conv(x)))))), 3x3 convs, BN
    folded at eval, dp the per-image drop-path in training."""

    def __init__(self, dim: int, *, official: bool, dtype: torch.dtype,
                 drop_path: float = 0.0) -> None:
        super().__init__()
        self.drop_path = DropPath(drop_path)
        self.conv1 = nn.Conv2d(dim, dim, 3, bias=official)
        self.norm1 = nn.BatchNorm2d(dim)
        self.conv2 = nn.Conv2d(dim, dim, 3, bias=official)
        self.norm2 = nn.BatchNorm2d(dim)
        if not official:
            self.gamma = nn.Parameter(torch.full((dim,), _LAYER_SCALE_INIT))
        self.cb1 = ConvBN(self.conv1, self.norm1, pads=_PAD1, act=gelu, dtype=dtype)
        self.cb2 = ConvBN(self.conv2, self.norm2, pads=_PAD1, dtype=dtype)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        h = self.cb2(self.cb1(x))
        if hasattr(self, "gamma"):
            h = h * self.gamma.to(h.dtype).view(1, -1, 1, 1)
        return x + self.drop_path(h, generator)


class Downsample(nn.Module):
    """Channel LayerNorm (eps 1e-6, f32, then the compute dtype) and a 3x3
    stride-2 conv from ``dim`` to ``dim_out`` channels (2 * dim by default)
    with symmetric padding 1, no bias. At eval the conv takes
    the cached rounded weight; in training the weight is cast on every call
    and the conv runs in the compute dtype, so the gradient reaches it."""

    def __init__(self, dim: int, *, dtype: torch.dtype, dim_out: int | None = None) -> None:
        super().__init__()
        self.dtype = dtype
        self.norm = LayerNorm(dim, 1e-6, dtype=dtype)
        self.reduction = nn.Sequential(nn.Conv2d(dim, dim_out or 2 * dim, 3, 2, bias=False))
        # the weight rounded to the compute dtype; the conv (cuDNN on the card)
        # takes f32 copies of both operands, exact, and accumulates in f32
        self._weight = Derived(lambda: self.reduction[0].weight.to(dtype).float()
                               .contiguous(memory_format=torch.channels_last))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.norm(x.permute(0, 2, 3, 1)).permute(0, 3, 1, 2)
        if self.training:
            return F.conv2d(h, self.reduction[0].weight.to(self.dtype), None, 2, 1)
        w = self._weight.get([self.reduction[0].weight])
        return F.conv2d(h.float(), w, None, 2, 1).to(self.dtype)


class TokenInitializer(nn.Module):
    """The official carrier-token tokenizer: depthwise 3x3 conv with bias
    (the wheel registers it as ``pos_embed`` and ``to_global_feature.pos``),
    then ``to_global_feature.pool``."""

    def __init__(self, dim: int, kernel: int, stride: int) -> None:
        super().__init__()
        self.pos_embed = nn.Conv2d(dim, dim, 3, groups=dim)
        self.to_global_feature = nn.Sequential()
        self.to_global_feature.add_module("pos", self.pos_embed)
        self.to_global_feature.add_module("pool", nn.AvgPool2d(kernel, stride))


class HATBlock(nn.Module):
    """Stage-3 block: the carrier tokens attend among themselves, then each
    window attends jointly over [its CTs; its tokens] (53 tokens)."""

    def __init__(self, dim: int, num_heads: int, *, window: int, ct_size: int, n_win: int,
                 last: bool, official: bool, mlp_ratio: float, dtype: torch.dtype,
                 drop_path: float = 0.0) -> None:
        super().__init__()
        self.drop_path = DropPath(drop_path)
        self.window, self.ct_size, self.n_win = window, ct_size, n_win
        self.last, self.official = last, official
        ct_side = ct_size * n_win
        if official:
            self.pos_embed = AbsPosMLP(dim, window)
            self.hat_pos_embed = AbsPosMLP(dim, ct_side)
        kw = dict(official=official, mlp_ratio=mlp_ratio, dtype=dtype)
        _add_subblock(self, "hat_", dim, num_heads, ct_side**2, window=ct_side, n_global=0, **kw)
        _add_subblock(self, "", dim, num_heads, ct_size**2 + window**2, window=window,
                      n_global=ct_size**2 if official else 0, **kw)

    def forward(self, xw: torch.Tensor, ct: torch.Tensor,
                generator: torch.Generator | None = None) -> tuple[torch.Tensor, torch.Tensor]:
        """xw [B*nW, win², C]; ct [B, nW*ct², C], window-major. Drop-path
        masks are per image in the carrier-token sub-block and per window in
        the window sub-block, as the rows of each sub-block's input."""
        BnW, Nw, C = xw.shape
        per_win = self.ct_size**2
        if self.official:
            xw = self.pos_embed(xw)
            ctg = self.hat_pos_embed(ct_dewindow(ct, self.n_win, self.ct_size))
            ct = ct_window(_run_subblock(self, "hat_", ctg, generator), self.n_win,
                           self.ct_size)
        else:
            ct = _run_subblock(self, "hat_", ct, generator)
        y = _run_subblock(self, "", torch.cat([ct.reshape(BnW, per_win, C), xw], dim=1),
                          generator)
        ct_w, xw = y[:, :per_win], y[:, per_win:]
        if self.last and not self.official:
            # propagation: nearest-upsample each window's CT grid to the window
            cs, ws = self.ct_size, self.window
            reps = ws // cs + (1 if ws % cs else 0)
            up = ct_w.reshape(BnW, cs, cs, C).repeat_interleave(reps, 1).repeat_interleave(reps, 2)
            xw = xw + up[:, :ws, :ws].reshape(BnW, Nw, C)
        return xw, ct_w.reshape(ct.shape)


class PlainBlock(nn.Module):
    """Stage-4 block: the map is one window of global attention; stage 3's
    too where its map is one window or less."""

    def __init__(self, dim: int, num_heads: int, *, grid: int, official: bool,
                 mlp_ratio: float, dtype: torch.dtype, drop_path: float = 0.0) -> None:
        super().__init__()
        self.drop_path = DropPath(drop_path)
        if official:
            self.pos_embed = AbsPosMLP(dim, grid)
        _add_subblock(self, "", dim, num_heads, grid * grid, window=grid, n_global=0,
                      official=official, mlp_ratio=mlp_ratio, dtype=dtype)

    def forward(self, tokens: torch.Tensor,
                generator: torch.Generator | None = None) -> torch.Tensor:
        if hasattr(self, "pos_embed"):
            tokens = self.pos_embed(tokens)
        return _run_subblock(self, "", tokens, generator)


class FasterViT(nn.Module):
    """FasterViT classifier over normalized NCHW-logical images at
    ``img_size`` (224: stage 3 at 14x14, 2x2 windows of 7x7; 448: 28x28,
    4x4 windows, stage 4 at 14x14; 112 and below: stage 3 one window or less,
    ``PlainBlock``s); returns f32 logits. ``drop_path_rate`` is the JAX
    default 0.2, spread over the blocks as ``rate * i / (sum(depths) - 1)``
    for the i-th block of all stages.

    Benchmark variants of the JAX model, off by default:

    - ``conv_stage_dims`` (a, b): the stem's second conv and conv stages 1-2
      at a and b channels in place of dim and 2 dim (the JAX bench's
      ``--pad-conv-stages`` takes (128, 256)); random weights only, no
      checkpoint loads into it.
    - ``conv_remat``: in a training forward with autograd recording, each
      stage-1/2 ``ConvBlock`` runs under ``common.remat``: ``"full"`` (or
      True) recomputes the whole block in the backward; ``"save-conv"``
      keeps the raw conv outputs (``aten.convolution``'s, JAX's
      ``convbn_raw``) and recomputes the BatchNorm and GELU chains. The
      numbers are those of a forward without it."""

    def __init__(
        self,
        num_classes: int,
        dim: int = 96,
        in_dim: int = 64,
        depths: tuple[int, ...] = (3, 3, 8, 5),
        num_heads: tuple[int, ...] = (2, 4, 8, 16),
        *,
        official: bool = True,
        img_size: int = 224,
        window_size: int = 7,
        ct_size: int = 2,
        mlp_ratio: float = 4.0,
        drop_path_rate: float = 0.2,
        dtype: torch.dtype = torch.bfloat16,
        generator: torch.Generator | None = None,
        conv_stage_dims: tuple[int, int] | None = None,
        conv_remat: bool | str = False,
    ) -> None:
        super().__init__()
        if conv_remat not in (False, None, True, "full", "save-conv"):
            raise ValueError(f"conv_remat must be False, 'full' or 'save-conv', got {conv_remat!r}")
        # None: no conv-stage remat; else the operators whose outputs it keeps
        self.conv_save = (None if not conv_remat else
                          (torch.ops.aten.convolution.default,) if conv_remat == "save-conv"
                          else ())
        self.dtype, self.official = dtype, official
        self.window_size, self.ct_size = window_size, ct_size
        self.res3 = stage3_resolution(img_size)
        # carrier tokens only where stage 3 is more than one window
        self.use_ct = self.res3 > window_size
        if self.use_ct and self.res3 % window_size:
            raise ValueError(
                f"FasterViT stage-3 resolution {self.res3}x{self.res3} (img_size / 16) must be "
                f"divisible by window_size {window_size}; use an img_size that is a multiple of "
                f"{16 * window_size} (e.g. 224) or adjust window_size"
            )
        if self.use_ct:
            self.n_win = self.res3 // window_size
            ct_side = ct_size * self.n_win
            self.ct_stride = self.res3 // ct_side
            self.ct_kernel = self.res3 - (ct_side - 1) * self.ct_stride
        self.res4 = (self.res3 + 1) // 2

        widths = [*(conv_stage_dims or (dim, 2 * dim)), 4 * dim, 8 * dim]
        self.patch_embed = nn.Module()
        self.patch_embed.conv_down = nn.Sequential(
            nn.Conv2d(3, in_dim, 3, 2, bias=False), nn.BatchNorm2d(in_dim, eps=1e-4), nn.ReLU(),
            nn.Conv2d(in_dim, widths[0], 3, 2, bias=False), nn.BatchNorm2d(widths[0], eps=1e-4),
            nn.ReLU(),
        )
        cd = self.patch_embed.conv_down
        self.stem = [ConvBN(cd[i], cd[i + 1], pads=_PAD1, act=F.relu, dtype=dtype) for i in (0, 3)]

        total = sum(depths)
        rates = iter([drop_path_rate * i / max(total - 1, 1) for i in range(total)])
        self.levels = nn.ModuleList()
        for i in range(4):
            level = nn.Module()
            width = widths[i]
            if i < 2:
                blocks = [ConvBlock(width, official=official, dtype=dtype, drop_path=next(rates))
                          for _ in range(depths[i])]
            elif i == 2 and not self.use_ct:
                blocks = [PlainBlock(width, num_heads[i], grid=self.res3, official=official,
                                     mlp_ratio=mlp_ratio, dtype=dtype, drop_path=next(rates))
                          for _ in range(depths[i])]
            elif i == 2:
                blocks = [HATBlock(width, num_heads[i], window=window_size, ct_size=ct_size,
                                   n_win=self.n_win, last=b == depths[i] - 1, official=official,
                                   mlp_ratio=mlp_ratio, dtype=dtype, drop_path=next(rates))
                          for b in range(depths[i])]
                if official:
                    level.global_tokenizer = TokenInitializer(width, self.ct_kernel,
                                                              self.ct_stride)
                else:
                    level.ct_pos_embed = nn.Parameter(torch.zeros(self.res3, self.res3, width))
                    level.win_pos_embed = nn.Parameter(torch.zeros(window_size**2, width))
            else:
                blocks = [PlainBlock(width, num_heads[i], grid=self.res4, official=official,
                                     mlp_ratio=mlp_ratio, dtype=dtype, drop_path=next(rates))
                          for _ in range(depths[i])]
                if not official:
                    level.pos_embed_table = nn.Parameter(torch.zeros(self.res4**2, width))
            level.blocks = nn.ModuleList(blocks)
            if i < 3:
                level.downsample = Downsample(width, dtype=dtype, dim_out=widths[i + 1])
            self.levels.append(level)
        self.norm = nn.BatchNorm2d(dim * 8)
        self.head = nn.Linear(dim * 8, num_classes)
        name_conv_bns(self)
        refusal = k6_refusal(img_size, window_size, ct_size)
        if refusal and any(a.fused for a in self.attentions()):
            raise ValueError(refusal)
        if generator is not None:
            self.reset_parameters(generator)

    @torch.no_grad()
    def reset_parameters(self, generator: torch.Generator) -> None:
        """Seeded init, drawn on the CPU from ``generator``: convs N(0,
        2/fan_in), linear weights N(0, 0.02²) (the wheel's truncated normal
        without the truncation), position tables N(0, 0.02²), zero biases and
        bias tables, identity norms, layer scale 1e-5."""
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fan_in = m.weight[0].numel()
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator)
                               * math.sqrt(2.0 / fan_in))
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.Linear):
                m.weight.copy_(torch.randn(m.weight.shape, generator=generator) * 0.02)
                if m.bias is not None:
                    m.bias.zero_()
            elif isinstance(m, (nn.BatchNorm2d, nn.LayerNorm)):
                m.reset_parameters()
        for name, p in self.named_parameters():
            if name.rsplit(".", 1)[-1].startswith(("gamma", "hat_gamma")):
                p.fill_(_LAYER_SCALE_INIT)
            elif name.endswith("rel_bias"):
                p.zero_()
            elif name.endswith(("ct_pos_embed", "win_pos_embed", "pos_embed_table")):
                p.copy_(torch.randn(p.shape, generator=generator) * 0.02)

    def attentions(self) -> list[TokenAttention]:
        return [m for m in self.modules() if isinstance(m, TokenAttention)]

    def _attention_tokens(self) -> dict[int, int]:
        """The token count of every attention, by ``id``: the carrier-token
        attentions' (ct_size * windows a side)², the window attentions'
        ct_size² + window², a ``PlainBlock``'s its grid's."""
        tokens = {}
        for blk in self.levels[2].blocks:
            if isinstance(blk, HATBlock):
                tokens[id(blk.hat_attn)] = (self.ct_size * self.n_win) ** 2
                tokens[id(blk.attn)] = self.ct_size**2 + self.window_size**2
            else:
                tokens[id(blk.attn)] = self.res3**2
        tokens.update({id(blk.attn): self.res4**2 for blk in self.levels[3].blocks})
        return tokens

    def kernel_launches_per_forward(self) -> dict[str, int]:
        """How many K5 and K6 launches one eval forward makes: without
        ``DFD_FUSED_ATTN``, K5 for every bf16 attention over at least 32
        tokens (13 for FasterViT-2 at 224 px; at 448 the 5 stage-4 ones are
        K5's long kernel, ``k5_long``); with it, K6 for every bf16 attention
        (21)."""
        tokens = self._attention_tokens()
        kernels = [a.kernel(tokens[id(a)]) for a in self.attentions()]
        return {k: kernels.count(k) for k in ("k5", "k5_long", "k6")}

    def kernel_launches_per_step(self, head_only: bool = False) -> dict[str, int]:
        """K5 and K6 forward and backward launches of one train step: the
        forward's, and as many backward ones unless only the head trains (the
        warmup: no gradient flows below the head, so autograd runs no
        backward there)."""
        fwd = self.kernel_launches_per_forward()
        out = {}
        for k in ("k5", "k5_long", "k6"):
            out[k], out[f"{k}_bwd"] = fwd[k], 0 if head_only else fwd[k]
        return out

    def _carrier_tokens(self, x: torch.Tensor) -> torch.Tensor:
        """[B, C, H, W] -> [B, nW*ct², C], window-major: the tokenizer's map
        average-pooled to a (ct·nW)² grid."""
        level = self.levels[2]
        if self.official:
            conv = level.global_tokenizer.pos_embed
            w = conv.weight.to(self.dtype).float()
            feat = F.conv2d(x.float(), w, None, 1, 1, 1, conv.groups).to(self.dtype)
            feat = feat + conv.bias.to(self.dtype).view(1, -1, 1, 1)
        else:
            feat = x + level.ct_pos_embed.permute(2, 0, 1).to(self.dtype)[None]
        grid = F.avg_pool2d(feat.float(), self.ct_kernel, self.ct_stride).to(self.dtype)
        B, C = grid.shape[:2]
        nw, cs = self.n_win, self.ct_size
        grid = grid.permute(0, 2, 3, 1).reshape(B, nw, cs, nw, cs, C)
        return grid.permute(0, 1, 3, 2, 4, 5).reshape(B, nw * nw * cs * cs, C)

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        """Logits of a normalized batch; in training ``generator`` draws the
        drop-path masks (needed when the rate is above 0)."""
        return self.classify(self.cam_features(x, generator))

    def classify(self, feats: torch.Tensor) -> torch.Tensor:
        """f32 logits of the [B, C, H, W] map: its f32 mean pool through
        ``head``."""
        B, C, H, W = feats.shape
        return self.head(feats.permute(0, 2, 3, 1).reshape(B, H * W, C).float().mean(dim=1))

    def cam_features(self, x: torch.Tensor,
                     generator: torch.Generator | None = None) -> torch.Tensor:
        """The final norm's [B, C, H, W] map in the compute dtype (the JAX
        model's ``cam_features``), a view of the stage-4 tokens."""
        dt = self.dtype
        x = x.to(dt).contiguous(memory_format=torch.channels_last)
        for stem in self.stem:
            x = stem(x)
        for level in self.levels[:2]:
            for blk in level.blocks:
                if self.conv_save is not None and self.training:
                    x = remat(blk, x, generator, generator=generator, save=self.conv_save)
                else:
                    x = blk(x, generator)
            x = level.downsample(x)

        level = self.levels[2]
        B, C, H, W = x.shape
        if (H, W) != (self.res3, self.res3):
            raise ValueError(f"FasterViT: stage 3 at {H}x{W}, built for {self.res3}: build "
                             f"the model at the input's img_size")
        if self.use_ct:
            ct = self._carrier_tokens(x)
            xw = window_partition(x, self.window_size)
            if not self.official:
                xw = xw + level.win_pos_embed.to(dt)[None]
            for blk in level.blocks:
                xw, ct = blk(xw, ct, generator)
            x = window_reverse(xw, self.window_size, H, W, B)
        else:  # one window or less: plain blocks over the map's tokens
            tokens = x.permute(0, 2, 3, 1).reshape(B, H * W, C)
            for blk in level.blocks:
                tokens = blk(tokens, generator)
            x = tokens.reshape(B, H, W, C).permute(0, 3, 1, 2)
        x = level.downsample(x)

        level = self.levels[3]
        B, C, H, W = x.shape
        tokens = x.permute(0, 2, 3, 1).reshape(B, H * W, C)
        if not self.official:
            tokens = tokens + level.pos_embed_table.to(dt)[None]
        for blk in level.blocks:
            tokens = blk(tokens, generator)

        n = self.norm
        if n.training:
            y = batch_norm_train(n, tokens)
        else:
            y = tokens.float()
            y = (y - n.running_mean) * torch.rsqrt(n.running_var + n.eps) * n.weight + n.bias
        return y.to(dt).reshape(B, H, W, C).permute(0, 3, 1, 2)


def create_faster_vit(
    variant: str = "2",
    *,
    num_classes: int = 2,
    dtype: torch.dtype = torch.bfloat16,
    head_config: str = "tpu",
    drop_path_rate: float = 0.2,
    generator: torch.Generator | None = None,
    conv_stage_dims: tuple[int, int] | None = None,
    conv_remat: bool | str = False,
    img_size: int = 224,
) -> FasterViT:
    """The variant at its published widths (or its conv stages at
    ``conv_stage_dims``), built for ``img_size``. ``head_config``:
    "official" (the wheel's model, which its ``.pth`` files load into) or
    "tpu". ``conv_remat``: see ``FasterViT``."""
    key = variant.split("_")[0]
    if key not in _VARIANTS:
        raise KeyError(f"unknown FasterViT variant '{variant}'")
    if head_config not in ("official", "tpu"):
        raise ValueError(f"head_config must be 'official' or 'tpu', got {head_config!r}")
    cfg = _VARIANTS[key]
    official = head_config == "official"
    heads = cfg["num_heads"] if official else tpu_heads(cfg["dim"], cfg["num_heads"])
    return FasterViT(num_classes, cfg["dim"], cfg["in_dim"], cfg["depths"], heads,
                     official=official, drop_path_rate=drop_path_rate, dtype=dtype,
                     generator=generator, conv_stage_dims=conv_stage_dims,
                     conv_remat=conv_remat, img_size=img_size)
