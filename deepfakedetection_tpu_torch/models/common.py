"""Shared building blocks: ConvBN (BN folded at eval, batch statistics in
training), a standalone BatchNorm's train path, SqueezeExcite, DropPath, and
for the transformers LayerNorm, Linear, Mlp and GELU.

Port of ``deepfakedetection_tpu/models/common.py``. Activations are
NCHW-logical tensors stored channels_last, so ``x.permute(0, 2, 3, 1)`` is the
contiguous NHWC view the kernels take. Parameters stay f32; compute runs in
the model's dtype (bf16 by default), cast explicitly: no autocast and no
GradScaler (``docs/PARITY.md`` delta 1).

``ConvBN`` and ``SqueezeExcite`` are plain objects over ``nn.Conv2d`` /
``nn.BatchNorm2d`` modules that the owning model registers under the
efficientnet_pytorch names (``_expand_conv`` + ``_bn0`` ...), so a reference
``.pth`` loads with ``strict=True`` and no renaming.
"""

from __future__ import annotations

import contextlib
import contextvars
from collections.abc import Callable, Iterator, Sequence

import torch
import torch.nn.functional as F
import torch.utils.checkpoint
from torch import nn

from deepfakedetection_tpu_torch.ops import quant
from deepfakedetection_tpu_torch.ops.depthwise_se import depthwise_silu_pool
from deepfakedetection_tpu_torch.parallel import mesh
from deepfakedetection_tpu_torch.runtime.flags import exact_gelu

Pads = tuple[tuple[int, int], tuple[int, int]]

# BatchNorm running-stat decay override for BN recalibration: at decay 0 a
# training forward leaves each layer's running statistics equal to that
# batch's statistics.
_BN_DECAY_OVERRIDE: contextvars.ContextVar[float | None] = contextvars.ContextVar(
    "bn_decay_override", default=None
)


@contextlib.contextmanager
def bn_momentum_override(value: float | None) -> Iterator[None]:
    """Running-stat decay (the JAX package's momentum convention: 0.99 keeps
    99% of the old value) for every ConvBN training forward in the block."""
    token = _BN_DECAY_OVERRIDE.set(value)
    try:
        yield
    finally:
        _BN_DECAY_OVERRIDE.reset(token)


def effective_bn_decay(default: float) -> float:
    override = _BN_DECAY_OVERRIDE.get()
    return default if override is None else override


# set while a checkpoint recomputes its forward in the backward (``remat``)
_RECOMPUTING: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "recomputing", default=False
)


@contextlib.contextmanager
def recomputation() -> Iterator[None]:
    """Marks a checkpoint's recompute: BatchNorm training forwards in it
    leave the running statistics and ``num_batches_tracked`` as the first
    forward left them (JAX takes the mutated ``batch_stats`` once, as an
    output of the checkpointed forward)."""
    token = _RECOMPUTING.set(True)
    try:
        yield
    finally:
        _RECOMPUTING.reset(token)


def update_running_stats(bn: nn.BatchNorm2d, mean: torch.Tensor, var: torch.Tensor) -> None:
    """One training forward's update of ``bn``'s running statistics at the
    override-aware decay (``effective_bn_decay``), none in a recompute."""
    if _RECOMPUTING.get():
        return
    decay = effective_bn_decay(1.0 - bn.momentum)
    with torch.no_grad():
        bn.running_mean.copy_(decay * bn.running_mean + (1.0 - decay) * mean)
        bn.running_var.copy_(decay * bn.running_var + (1.0 - decay) * var)
        bn.num_batches_tracked.add_(1)


def generator_replay(generator: torch.Generator | None):
    """A checkpoint's (forward, recompute) contexts for an explicit
    generator, which ``checkpoint``'s ``preserve_rng_state`` does not cover:
    the forward notes the generator's state, the recompute draws from that
    state again (the same dropout and drop-path masks) and then puts back the
    state it found, so the draws after the step are those of a run without
    the checkpoint."""
    if generator is None:
        return contextlib.nullcontext(), contextlib.nullcontext()
    before: list[torch.Tensor] = []

    @contextlib.contextmanager
    def forward() -> Iterator[None]:
        before.append(generator.get_state())
        yield

    @contextlib.contextmanager
    def recompute() -> Iterator[None]:
        after = generator.get_state()
        generator.set_state(before[-1])
        try:
            yield
        finally:
            generator.set_state(after)

    return forward(), recompute()


@contextlib.contextmanager
def _entered(*contexts) -> Iterator[None]:
    with contextlib.ExitStack() as stack:
        for context in contexts:
            stack.enter_context(context)
        yield


def remat(fn: Callable[..., torch.Tensor], *args, generator: torch.Generator | None = None,
          save: Sequence[torch._ops.OpOverload] = ()) -> torch.Tensor:
    """``fn(*args)`` under a non-reentrant ``torch.utils.checkpoint``
    (``jax.checkpoint``'s counterpart): its activations are recomputed in
    the backward, with ``generator``'s draws replayed (``generator_replay``)
    and BatchNorm's running statistics left alone (``recomputation``).
    ``save`` names operators whose outputs are kept instead of recomputed
    (a selective checkpoint: ``save_only_these_names``). Without autograd
    recording it is ``fn(*args)``."""
    if not torch.is_grad_enabled():
        return fn(*args)

    def contexts():
        forward, recompute = generator_replay(generator)
        forward, recompute = [forward], [recompute, recomputation()]
        if save:
            caching, cached = torch.utils.checkpoint.create_selective_checkpoint_contexts(
                list(save))
            forward.append(caching)
            recompute.append(cached)
        return _entered(*forward), _entered(*recompute)

    return torch.utils.checkpoint.checkpoint(fn, *args, use_reentrant=False, context_fn=contexts)


# set while a tracer runs the model (``frozen_derived``)
_DERIVED_FROZEN: contextvars.ContextVar[bool] = contextvars.ContextVar(
    "derived_frozen", default=False
)


@contextlib.contextmanager
def frozen_derived() -> Iterator[None]:
    """Every ``Derived`` hands back the value its last eager call computed,
    without looking at its tensors: a tracer's fake tensors have no data
    pointer, and ``torch.export`` keeps the value as a constant of the
    program. Run one eager forward first; a value that it did not compute
    raises."""
    token = _DERIVED_FROZEN.set(True)
    try:
        yield
    finally:
        _DERIVED_FROZEN.reset(token)


class Derived:
    """A value computed from parameters (and hashable ``args`` passed on to
    the function), recomputed only when one of them changes (new storage, an
    in-place write such as ``load_state_dict``, other args). Under
    ``frozen_derived`` it returns the value it holds."""

    def __init__(self, fn: Callable[..., object]) -> None:
        self._fn = fn
        self._key: tuple | None = None
        self._value: object = None

    def get(self, tensors: Sequence[torch.Tensor], *args):
        if _DERIVED_FROZEN.get():
            if self._key is None or self._key[1] != args:
                raise RuntimeError(
                    "Derived.get under frozen_derived: no eager forward computed this value"
                )
            return self._value
        key = (tuple((t.data_ptr(), t._version) for t in tensors), args)
        if key != self._key:
            with torch.no_grad():
                self._value = self._fn(*args)
            self._key = key
        return self._value


def nhwc(x: torch.Tensor) -> torch.Tensor:
    """The contiguous NHWC view of a channels_last NCHW map, which the
    kernels take: no copy in an eager forward. A tracer's fake conv output
    may claim another layout (``torch.export`` on the card saw NCHW-contiguous
    stem convs), so the view is made contiguous here: the program then holds
    an ``aten.contiguous`` node, a no-op on the real map."""
    return x.permute(0, 2, 3, 1).contiguous()


def symmetric_pad(pads: Pads, k: int) -> bool:
    """True for the (k//2, k//2) zero padding the fused kernels implement."""
    r = k // 2
    return tuple(map(tuple, pads)) == ((r, r), (r, r))


class ConvBN:
    """Conv2d + BatchNorm2d (+ activation). In training (``bn.training``) it
    follows the JAX package's train path, not ``nn.BatchNorm2d``'s: the conv
    in the compute dtype with an output in that dtype; one-pass f32 batch
    statistics, ``E[y]`` and ``E[y^2]`` with ``var = max(E[y^2] - E[y]^2, 0)``
    (biased); running statistics updated at the decay ``1 - bn.momentum``
    (B3's 0.99, FasterViT's 0.9) with that biased variance (PARITY delta
    13); then ``y*a + b`` in the compute dtype, with
    ``a`` and ``b`` computed in f32 and cast; the activation; one cast. A conv
    bias is added to the conv output in the compute dtype first.

    At eval, BN (and a conv bias) is folded in f32:
    ``w' = w * gamma / sqrt(var + eps)``, ``b' = beta - (mean - conv_bias) *
    gamma / sqrt(var + eps)``. Input and weight are rounded to the compute dtype; the
    conv (cuDNN on the card) takes them as f32, so the products are exact and
    accumulation and output stay f32, as in the JAX package's bf16 conv with
    f32 accumulation. The f32 bias and the activation follow in f32, then one
    cast to the compute dtype: the only rounding after the conv. bf16 values
    are exact in TF32, so cuDNN's TF32 mode (PyTorch's default for convs)
    runs this on tensor cores without changing the result. ``pads`` are the
    frozen static-SAME pads ((top, bottom), (left, right)).

    ``return_spatial_mean=True`` returns ``(y, mean | None)``: the f32 spatial
    mean of y when the K1 kernel served the call (a depthwise, stride-1,
    odd-k, symmetric-pad SiLU conv in bf16), else None. ``fold_only=True``
    returns the folded ``(w, b)`` in the JAX package's layout (HWIO f32 and
    f32) without running the conv, for callers that fuse several convs into
    one kernel.

    Under a ``QuantCtx`` (``ops/quant.py``) at eval, a dense ConvBN, and a
    depthwise one unless the context leaves depthwise out, runs the int8
    path of the JAX package's ConvBN: with ``calibrate`` it records its input's
    range statistic under its ``name`` and runs the normal conv; otherwise,
    given a scale, it quantizes its input, runs the int8 conv (its int8
    weights derived once per set of weights and scale), then the activation
    and one cast. K1 stays off under any context. ``name`` is its conv's
    module name, set by ``name_conv_bns``."""

    name: str | None = None

    def __init__(
        self,
        conv: nn.Conv2d,
        bn: nn.BatchNorm2d,
        *,
        pads: Pads = ((0, 0), (0, 0)),
        act: Callable[[torch.Tensor], torch.Tensor] | None = None,
        dtype: torch.dtype = torch.bfloat16,
    ) -> None:
        if conv.padding != (0, 0):
            raise ValueError("ConvBN: the conv carries no padding of its own")
        self.conv, self.bn, self.act, self.dtype = conv, bn, act, dtype
        self.pads = tuple(map(tuple, pads))
        (pt, pb), (pl, pr) = self.pads
        # symmetric pads go to the conv itself; others need an explicit F.pad
        self._conv_pad = (pt, pl) if (pt, pl) == (pb, pr) else (0, 0)
        self._fpad = (0, 0, 0, 0) if (pt, pl) == (pb, pr) else (pl, pr, pt, pb)
        self._folded = Derived(self._fold)
        self._conv_weight = Derived(
            lambda: self._folded_now()[0]
            .to(dtype)
            .float()
            .contiguous(memory_format=torch.channels_last)
        )
        self._hwio = Derived(lambda: self._folded_now()[0].permute(2, 3, 1, 0).contiguous())
        self._int8 = Derived(lambda sx: quant.prepare(
            self._hwio.get(self._params()), self._folded_now()[1], sx, self.conv.groups))

    def _params(self) -> list[torch.Tensor]:
        bn = self.bn
        params = [self.conv.weight, bn.weight, bn.bias, bn.running_mean, bn.running_var]
        return params if self.conv.bias is None else params + [self.conv.bias]

    def _fold(self) -> tuple[torch.Tensor, torch.Tensor]:
        bn = self.bn
        denom = bn.weight.float() * torch.rsqrt(bn.running_var.float() + bn.eps)
        w = self.conv.weight.float() * denom.view(-1, 1, 1, 1)
        mean = bn.running_mean.float()
        if self.conv.bias is not None:
            mean = mean - self.conv.bias.float()
        return w, bn.bias.float() - mean * denom

    def _folded_now(self) -> tuple[torch.Tensor, torch.Tensor]:
        return self._folded.get(self._params())

    def k1_eligible(self) -> bool:
        c, k = self.conv, self.conv.kernel_size
        return (
            self.dtype == torch.bfloat16
            and c.groups == c.in_channels == c.out_channels
            and c.stride == (1, 1)
            and k[0] == k[1]
            and k[0] in (3, 5)
            and self.act is F.silu
            and symmetric_pad(self.pads, k[0])
        )

    def __call__(
        self,
        x: torch.Tensor | None,
        *,
        return_spatial_mean: bool = False,
        fold_only: bool = False,
    ):
        if self.bn.training:
            if fold_only:
                raise ValueError("ConvBN: fold_only is for eval")
            y = self._train_forward(x)
            return (y, None) if return_spatial_mean else y
        params = self._params()
        if fold_only:
            return self._hwio.get(params), self._folded.get(params)[1]
        qctx = quant.current_ctx()
        if qctx is not None and self.int8_eligible(qctx):
            x = x.to(self.dtype)
            if qctx.calibrate:
                qctx.record(self.name, quant.range_stat(x.permute(0, 2, 3, 1), qctx.calib_mode,
                                                        qctx.percentile))
            else:
                sx = qctx.scale_for(self.name)
                if sx is not None:
                    y = self._int8_forward(x, sx)
                    return (y, None) if return_spatial_mean else y
        _, b = self._folded.get(params)
        if return_spatial_mean and qctx is None and self.k1_eligible():
            k = self.conv.kernel_size[0]
            w = self._hwio.get(params)  # [k, k, 1, C]
            y, pool = depthwise_silu_pool(
                nhwc(x.to(self.dtype)), w.view(k, k, -1), b, k=k
            )
            return y.permute(0, 3, 1, 2), pool
        x = x.to(self.dtype).float()
        if any(self._fpad):
            x = F.pad(x, self._fpad)
        y = F.conv2d(
            x, self._conv_weight.get(params), b, self.conv.stride, self._conv_pad, 1,
            self.conv.groups,
        )
        if self.act is not None:
            y = self.act(y, inplace=True)
        y = y.to(self.dtype)
        return (y, None) if return_spatial_mean else y

    def int8_eligible(self, qctx: quant.QuantCtx) -> bool:
        c = self.conv
        depthwise = c.groups == c.in_channels == c.out_channels
        return c.groups == 1 or (depthwise and qctx.include_depthwise)

    def _int8_forward(self, x: torch.Tensor, sx: quant.Scale) -> torch.Tensor:
        """The int8 conv of NCHW-logical x (in the compute dtype), then the
        activation (fused into the epilogue where the kernel has it) and one
        cast."""
        qw = self._int8.get(self._params(), sx)
        act = _epilogue_act(self.act)
        y = quant.apply(x.permute(0, 2, 3, 1), qw, self.conv.stride, self.pads,
                        act=act or "none", out_dtype=self.dtype if act else torch.float32)
        if act is None:
            y = self.act(y).to(self.dtype)
        return y.permute(0, 3, 1, 2)

    def _train_forward(self, x: torch.Tensor) -> torch.Tensor:
        conv, bn, dt = self.conv, self.bn, self.dtype
        x = x.to(dt)
        if any(self._fpad):
            x = F.pad(x, self._fpad)
        y = F.conv2d(x, conv.weight.to(dt), None, conv.stride, self._conv_pad, 1, conv.groups)
        if conv.bias is not None:
            y = y + conv.bias.to(dt).view(1, -1, 1, 1)
        # One pass over y for each statistic, accumulated in f32; on the card
        # both reductions read the bf16 y without an f32 copy of it. Under a
        # process group the sums and the count are summed over the ranks in
        # one collective (with a backward), so the statistics are the global
        # batch's.
        dims = (0, 2, 3)
        n = y.numel() // y.shape[1]
        total = y.sum(dim=dims, dtype=torch.float32)
        squares = torch.linalg.vector_norm(y, 2, dim=dims, dtype=torch.float32).square()
        if mesh.data_axis() is not None:
            c = total.shape[0]
            count = torch.full((1,), float(n), device=total.device)
            sums = mesh.sum_over_data(torch.cat([total, squares, count]))
            total, squares, n = sums[:c], sums[c : 2 * c], sums[2 * c]
        mean = total / n
        mean2 = squares / n
        var = torch.clamp(mean2 - mean.square(), min=0.0)
        update_running_stats(bn, mean, var)
        denom = bn.weight * torch.rsqrt(var + bn.eps)
        a = denom.to(dt).view(1, -1, 1, 1)
        b = (bn.bias - mean * denom).to(dt).view(1, -1, 1, 1)
        y = y * a + b
        if self.act is not None:
            y = self.act(y)
        return y.to(dt)


def _epilogue_act(act) -> str | None:
    """The int8 epilogue's name for a ConvBN activation (``ops/int8_dw.ACTS``),
    None for one it does not have."""
    if act is None:
        return "none"
    if act is F.silu:
        return "silu"
    if act is gelu:
        return "gelu_erf" if exact_gelu() else "gelu_tanh"
    return None


def name_conv_bns(root: nn.Module) -> None:
    """Names every ConvBN held by a module under ``root`` (as an attribute,
    or in a list or tuple attribute) after its conv's module name, the key
    of its int8 activation scale."""
    names = {id(m): n for n, m in root.named_modules()}
    for module in root.modules():
        for value in vars(module).values():
            for item in value if isinstance(value, (list, tuple)) else (value,):
                if isinstance(item, ConvBN):
                    item.name = names[id(item.conv)]


def batch_norm_train(bn: nn.BatchNorm2d, x: torch.Tensor) -> torch.Tensor:
    """A standalone BatchNorm in training over a channels-last ``x`` (the
    channel is the last dim), as the JAX package's ``BatchNorm2d``, not
    ConvBN's chain: f32 batch statistics over every other dim, the variance
    in two passes and biased (``jnp.var``), the running statistics updated
    at the override-aware decay (``effective_bn_decay``; 0.9 from
    ``nn.BatchNorm2d``'s momentum 0.1, as the JAX module's 0.9), then
    ``(y - mean) * rsqrt(var + eps) * weight + bias`` in f32. Returns f32;
    the caller casts once. Under a process group each pass's sums are summed
    over the ranks (the first with the count), two collectives with a
    backward: the global batch's statistics."""
    y = x.float()
    dims = tuple(range(y.dim() - 1))
    if mesh.data_axis() is None:
        mean = y.mean(dim=dims)
        var = (y - mean).square().mean(dim=dims)
    else:
        c = y.shape[-1]
        count = torch.full((1,), float(y.numel() // c), device=y.device)
        sums = mesh.sum_over_data(torch.cat([y.sum(dim=dims), count]))
        n = sums[c]
        mean = sums[:c] / n
        var = mesh.sum_over_data((y - mean).square().sum(dim=dims)) / n
    update_running_stats(bn, mean, var)
    return (y - mean) * torch.rsqrt(var + bn.eps) * bn.weight + bn.bias


class SqueezeExcite:
    """SE gate: pool -> reduce 1x1 (+bias) -> SiLU -> expand 1x1 (+bias) ->
    sigmoid -> x * gate, in the compute dtype. ``pooled`` is a precomputed
    f32 [B, C] spatial mean (from K1/K2); it is cast to the compute dtype
    first, as the JAX package does. Without it, x is pooled with f32
    accumulation. At eval the compute-dtype weights are cached; in training
    they are cast on every call, so the gradient reaches the f32 weights."""

    def __init__(
        self, reduce: nn.Conv2d, expand: nn.Conv2d, *, dtype: torch.dtype = torch.bfloat16
    ) -> None:
        self.reduce, self.expand, self.dtype = reduce, expand, dtype
        self._weights = Derived(self._cast)

    def _tensors(self) -> list[torch.Tensor]:
        return [self.reduce.weight, self.reduce.bias, self.expand.weight, self.expand.bias]

    def _cast(self) -> tuple[torch.Tensor, ...]:
        return tuple(
            t.to(self.dtype).flatten(1) if t.dim() > 1 else t.to(self.dtype)
            for t in self._tensors()
        )

    def __call__(self, x: torch.Tensor, pooled: torch.Tensor | None = None) -> torch.Tensor:
        if self.reduce.training:
            wr, br, we, be = self._cast()
        else:
            wr, br, we, be = self._weights.get(self._tensors())
        se = pooled if pooled is not None else x.mean(dim=(2, 3), dtype=torch.float32)
        se = F.silu(F.linear(se.to(self.dtype), wr, br))
        gate = torch.sigmoid(F.linear(se, we, be))
        return x * gate[:, :, None, None]


def keep_mask(x: torch.Tensor, keep: float, shape: tuple[int, ...],
              generator: torch.Generator | None) -> torch.Tensor:
    """Bernoulli(keep) mask of ``shape`` on x's device from ``generator``.
    The leading dim runs over the batch (images, or an image's windows,
    batch-major); under a process group the mask is drawn for the global
    batch and this rank keeps its rows (``mesh.global_rows``)."""
    if generator is None:
        raise ValueError("a training forward with dropout needs an explicit torch.Generator")
    rows = mesh.global_rows(shape[0])
    if rows is None:
        return torch.rand(shape, generator=generator, device=x.device) < keep
    total, start = rows
    draw = torch.rand((total,) + tuple(shape[1:]), generator=generator, device=x.device)
    return draw[start : start + shape[0]] < keep


def dropout(x: torch.Tensor, rate: float, generator: torch.Generator | None) -> torch.Tensor:
    """Inverted dropout: each element kept with probability 1 - rate, the
    survivors scaled by 1 / (1 - rate)."""
    keep = 1.0 - rate
    return torch.where(keep_mask(x, keep, tuple(x.shape), generator), x / keep, 0.0)


class DropPath(nn.Module):
    """Stochastic depth per sample: in training each sample's branch is kept
    with probability 1 - rate (one Bernoulli draw per sample from the
    forward's generator) and the survivors scaled by 1 / (1 - rate); the
    identity at eval."""

    def __init__(self, rate: float) -> None:
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, generator: torch.Generator | None = None) -> torch.Tensor:
        if not self.training or self.rate <= 0.0:
            return x
        keep = 1.0 - self.rate
        mask = keep_mask(x, keep, (x.shape[0],) + (1,) * (x.dim() - 1), generator)
        return torch.where(mask, x / keep, 0.0)


def gelu(x: torch.Tensor, inplace: bool = False) -> torch.Tensor:
    """GELU in its tanh form, or erf with ``DFD_EXACT_GELU=1``
    (``runtime/flags.exact_gelu``). ``inplace`` is taken for ConvBN's
    activation call and ignored."""
    return F.gelu(x, approximate="none" if exact_gelu() else "tanh")


class LayerNorm(nn.LayerNorm):
    """LayerNorm over the last dim computed in f32, then cast to ``dtype``, as
    the JAX package's ``nn.LayerNorm(dtype=float32)`` followed by a cast."""

    def __init__(self, dim: int, eps: float, *, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__(dim, eps=eps)
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(
            x.float(), self.normalized_shape, self.weight, self.bias, self.eps
        ).to(self.dtype)


class Linear(nn.Linear):
    """nn.Linear in the compute dtype: input, weight and bias cast to ``dtype``
    (the casts cached at eval), output in ``dtype``, as the JAX package's
    ``nn.Dense(dtype=...)``. The bias joins the product before its one
    rounding (in the GEMM's epilogue on the card); the JAX package rounds the
    product and then the sum, at most one bf16 step apart."""

    def __init__(self, in_features: int, out_features: int, bias: bool = True, *,
                 dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__(in_features, out_features, bias)
        self.dtype = dtype
        self._cast = Derived(self._cast_now)

    def _tensors(self) -> list[torch.Tensor]:
        return [self.weight] if self.bias is None else [self.weight, self.bias]

    def _cast_now(self) -> tuple[torch.Tensor, torch.Tensor | None]:
        b = None if self.bias is None else self.bias.to(self.dtype)
        return self.weight.to(self.dtype), b

    def cast(self) -> tuple[torch.Tensor, torch.Tensor | None]:
        """(weight, bias) in the compute dtype: cached at eval, cast anew in
        training."""
        return self._cast_now() if self.training else self._cast.get(self._tensors())

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w, b = self.cast()
        return F.linear(x.to(self.dtype), w, b)


class Mlp(nn.Module):
    """Transformer MLP: fc1 -> GELU -> fc2, in the compute dtype."""

    def __init__(self, dim: int, hidden: int, *, dtype: torch.dtype = torch.bfloat16) -> None:
        super().__init__()
        self.fc1 = Linear(dim, hidden, dtype=dtype)
        self.fc2 = Linear(hidden, dim, dtype=dtype)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(gelu(self.fc1(x)))


def make_divisible(value: float, divisor: int = 8, min_value: int | None = None) -> int:
    """Standard channel rounding used across mobile-net-family models."""
    if min_value is None:
        min_value = divisor
    new_value = max(min_value, int(value + divisor / 2) // divisor * divisor)
    if new_value < 0.9 * value:
        new_value += divisor
    return int(new_value)
