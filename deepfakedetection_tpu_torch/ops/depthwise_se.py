"""K1: fused stride-1 depthwise conv + bias + SiLU + SE spatial mean.

Port of ``deepfakedetection_tpu/ops/pallas/depthwise_se.py``
(``depthwise_silu_pool``). The CUDA kernel is ``csrc/depthwise_se.cu``: a
persistent grid walking whole images in bands of rows through a circular
buffer, the pool summed in registers (``plan`` mirrors its launch plan).
``depthwise_silu_pool_plain`` is the same contract in plain PyTorch, with
the same rounding points, which the wrapper runs for CPU tensors and the
tests and ``chip_smoke.py`` hold the kernel against. The wrapper calls the
operator ``torch.ops.dfd.depthwise_silu_pool`` (``build.define_op``), so
``torch.export`` records the launch as one node.

Layout is the JAX package's: NHWC. A channels_last NCHW activation gives
that view with ``x.permute(0, 2, 3, 1)`` at no copy.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import torch
import torch.nn.functional as F

from deepfakedetection_tpu_torch.ops import build

MAX_SMEM_BYTES = 232448  # shared memory one H100 block may use
SMS = 132  # an H100 SXM's SMs, the default the plan is computed for
NPX = 4  # output pixels of one thread's unit
MAX_RB = 8  # rows of a band
MAX_THREADS = 768  # a block's threads at most: 85 registers each


@dataclass(frozen=True)
class Plan:
    """The kernel's launch plan (``make_plan`` in csrc/depthwise_se.cu):
    channel blocks of CB channels (G groups of 4, the block padded to a
    multiple of 8), bands of RB rows through a circular buffer of NR rows
    (bands a map), T threads a group, threads a block, items (image x channel
    block), the persistent grid and its shared memory bytes."""

    CB: int
    G: int
    RB: int
    NR: int
    bands: int
    T: int
    threads: int
    items: int
    grid: int
    smem: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _align16(n: int) -> int:
    return (n + 15) & ~15


def smem_bytes(W: int, k: int, CB: int, NR: int, threads: int) -> int:
    """The ring of NR rows plus the zero row (CB padded to 8 channels a
    pixel), the taps' weights, the bias and the pool's per-thread sums."""
    CBp = _cdiv(CB, 8) * 8
    ring_px = (NR + 1) * (_cdiv(W, NPX) * NPX + k - 1)
    return _align16(2 * ring_px * CBp) + 4 * k * k * CBp + 4 * CBp + 4 * threads * 4


def plan(B: int, H: int, W: int, C: int, k: int, sms: int = SMS) -> Plan:
    """Mirrors ``make_plan``: CB = C up to 64, else 64; the widest band up to
    MAX_RB rows whose buffer fits; the fewest rounds of units a band with at
    most MAX_THREADS threads, spread evenly over the group's T threads; one
    block an SM."""
    CB = min(C, 64)
    G = _cdiv(CB, 8) * 2
    items = _cdiv(C, CB) * B
    RB = min(H, MAX_RB)
    while True:
        NR = 2 * RB + k - 1
        units = RB * _cdiv(W, NPX)
        rounds = _cdiv(units * G, MAX_THREADS)
        while _cdiv(units, rounds) * G > MAX_THREADS:
            rounds += 1
        T = _cdiv(units, rounds)
        smem = smem_bytes(W, k, CB, NR, T * G)
        if smem <= MAX_SMEM_BYTES or RB == 1:
            break
        RB -= 1
    return Plan(CB, G, RB, NR, _cdiv(H, RB), T, T * G, items, min(items, sms), smem)


def kernel_plan(B: int, H: int, W: int, C: int, k: int, sms: int) -> Plan:
    """The plan the built kernel computes (``dfd_depthwise_plan``), to hold
    ``plan`` to on the card."""
    out = (ctypes.c_int * 10)()
    build.check(build.library().dfd_depthwise_plan(B, H, W, C, k, sms, out), "kernel_plan")
    return Plan(*out)


def depthwise_silu_pool_plain(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """x [B,H,W,C] bf16, w [k,k,C] f32, b [C] f32 -> (y [B,H,W,C] bf16 =
    silu(dw(x) + b) with zero padding k//2, pool [B,C] f32 = mean of the
    bf16-rounded y). Taps and bias in f32."""
    C = x.shape[-1]
    xf = x.float().permute(0, 3, 1, 2)
    wf = w.permute(2, 0, 1).reshape(C, 1, k, k)
    acc = F.conv2d(xf, wf, None, 1, k // 2, 1, C) + b.view(1, C, 1, 1)
    y = F.silu(acc).to(torch.bfloat16).permute(0, 2, 3, 1).contiguous()
    return y, y.float().mean(dim=(1, 2))


def _check(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, k: int) -> None:
    if k not in (3, 5):
        raise ValueError(f"depthwise_silu_pool: k must be 3 or 5, got {k}")
    if x.dim() != 4 or x.dtype != torch.bfloat16 or not x.is_contiguous():
        raise ValueError(
            "depthwise_silu_pool: x must be a contiguous NHWC bf16 tensor, got "
            f"shape {tuple(x.shape)} {x.dtype} strides {x.stride()}"
        )
    C = x.shape[-1]
    for name, t, shape in (("w", w, (k, k, C)), ("b", b, (C,))):
        if tuple(t.shape) != shape or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"depthwise_silu_pool: {name} must be contiguous f32 {shape}, got "
                f"{tuple(t.shape)} {t.dtype}"
            )
        if t.device != x.device:
            raise ValueError(f"depthwise_silu_pool: {name} on {t.device}, x on {x.device}")


def _launch_plan(x: torch.Tensor, k: int) -> Plan:
    B, H, W, C = x.shape
    p = plan(B, H, W, C, k)
    if p.smem > MAX_SMEM_BYTES:
        raise ValueError(f"depthwise_silu_pool: {p} needs more than {MAX_SMEM_BYTES} B")
    return p


def _cuda(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, k: int):
    """The operator's CUDA implementation: one launch of the kernel on the
    current stream, counted."""
    _check(x, w, b, k)
    _launch_plan(x, k)
    B, H, W, C = x.shape
    y = torch.empty_like(x)
    pool = torch.empty((B, C), dtype=torch.float32, device=x.device)
    lib = build.library()
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = lib.dfd_depthwise_silu_pool(
            x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), pool.data_ptr(),
            B, H, W, C, k, stream,
        )
    build.check(rc, "depthwise_silu_pool")
    depthwise_silu_pool.launches += 1
    return y, pool


def _cpu(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, k: int):
    _check(x, w, b, k)
    return depthwise_silu_pool_plain(x, w, b, k=k)


def _fake(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, k: int):
    """Output shapes for tracers, after the checks the launch makes."""
    _check(x, w, b, k)
    if x.device.type == "cuda":
        _launch_plan(x, k)
    return torch.empty_like(x), x.new_empty((x.shape[0], x.shape[-1]), dtype=torch.float32)


_op = build.define_op(
    "depthwise_silu_pool(Tensor x, Tensor w, Tensor b, int k) -> (Tensor, Tensor)",
    cuda=_cuda, cpu=_cpu, fake=_fake,
)


def depthwise_silu_pool(
    x: torch.Tensor, w: torch.Tensor, b: torch.Tensor, *, k: int
) -> tuple[torch.Tensor, torch.Tensor]:
    """K1 (see ``depthwise_silu_pool_plain`` for the contract) through the
    operator ``torch.ops.dfd.depthwise_silu_pool``: it launches the CUDA
    kernel on the current stream for a CUDA tensor and runs the plain
    version for a CPU tensor; any other device raises here."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"depthwise_silu_pool: unsupported device {x.device}")
    return _op(x, w, b, k)


depthwise_silu_pool.launches = 0
