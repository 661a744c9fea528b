"""K7 (``ops/csrc/attn4d.cu``, talking-head attention) against another
checkout's, on one CUDA card, at ``chip_smoke.K7_SHAPES`` (EfficientFormerV2-S1's
shape at batch 256) and ``chip_smoke.K7_ODD``; with ``--long`` K7's long
kernel (``attn4d_long.cu``, past 128 tokens) at ``chip_smoke.K7_LONG_SHAPES``
(S1 at 384, 512 and 640 px, batch 128) and ``K7_LONG_ODD``, and each long
kernel's cycles by phase. Run from the repository root:

    python -m deepfakedetection_tpu_torch.profile_k7 --tree DIR [--tree DIR ...] [--long]

It builds the K7 of another checkout (say the parent commit, unpacked with
``git archive`` into a directory ``.gitignore`` lists) from its ``attn4d.cu``
(``attn4d_long.cu``) and the headers it includes, and from nothing else, runs
the same operands through both entry points at every shape the other takes
(this checkout's held to the plain version within two bf16 steps of the
output's scale; the other's distance from it reported, and whether the two
outputs are bit-identical) and times both at the timed shapes in turns
(other, this, this, other), by CUDA events and by the device time of their
kernels. ``chip_smoke.py --parent DIR`` runs both comparisons in its phase 1
and requires bit-identical outputs of the short kernels.

``phases`` builds a tree's long kernel with clock64 laps of one thread
(``-DDFD_K7_CLOCKS``; for the one-block-a-query-tile design, which has no
such hooks, a copy with laps written in at its phase comments): the
two-walk design's walk 1, walk 2 and ring waits of consumer warp 0 and the
producer's ring waits and copies; the earlier design's setup, phases A and B,
and phase C's math and v copies. Each phase's share of its thread's cycles.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import re
import shutil
import subprocess
from pathlib import Path

KERNELS = ("attn4d_kernel",)  # the device kernel of both designs, as the profiler names it
LONG_KERNELS = ("attn4d_long_kernel",)
# the clock laps' categories (dfd_k7_clocks): the two-walk design's, the
# consumer's first five and the producer's last two; the design before
PHASES = ("walk 1", "walk 2 scores and p", "walk 2 exchange barrier", "walk 2 th2 and p2 v",
          "consumer ring waits", "producer ring waits", "producer copies")
TILE_PHASES = ("setup", "A: q k^T", "B: mixes and softmax", "C: p2 v", "C: v copies")
_P, _I, _F, _L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong


def build_alone(csrc: Path, source: str, defines: tuple[str, ...] = ()) -> ctypes.CDLL:
    """``csrc/source`` built alone into ``build/profile_k7/`` (cached by the
    sources', flags' and defines' hash) and loaded."""
    from deepfakedetection_tpu_torch.ops import build

    digest = hashlib.sha256(" ".join(build.NVCC_FLAGS + defines).encode())
    for src in sorted(csrc.glob("*.cu*")):
        digest.update(src.read_bytes())
    name = f"{Path(source).stem}_{digest.hexdigest()[:16]}.so"
    out = build.BUILD_DIR.parent / "profile_k7" / name
    if not out.exists():
        out.parent.mkdir(parents=True, exist_ok=True)
        subprocess.run([build._nvcc(), *build.NVCC_FLAGS, *defines, "-shared", "-o", str(out),
                        str(csrc / source)], check=True)
    return ctypes.CDLL(str(out))


def _launch(fn, sms: bool, name: str, q, k, v, bias, th1, th1_b, th2, th2_b, *,
            num_heads: int, scale: float):
    """One call of another tree's C entry ``fn`` (with the card's SM count
    where ``sms``) on the current stream; raises on its error."""
    import torch

    from deepfakedetection_tpu_torch.ops.attn4d import strides_vec
    from deepfakedetection_tpu_torch.ops.expand_dw import sm_count

    B, N, Cq = q.shape
    d, dv = Cq // num_heads, v.shape[2] // num_heads
    out = torch.empty(B, N, num_heads * dv, dtype=torch.bfloat16, device=q.device)
    strides, vec = strides_vec(q, k, v)
    rc = fn(*(t.data_ptr() for t in (q, k, v, bias, th1, th1_b, th2, th2_b)), out.data_ptr(), B,
            N, num_heads, d, dv, *strides, *([sm_count(q.device)] if sms else []), float(scale),
            vec, torch.cuda.current_stream().cuda_stream)
    if rc:
        raise RuntimeError(f"the other tree's {name} failed: CUDA error {rc}")
    return out


class Other:
    """K7 of the checkout in ``tree``, built alone into ``build/profile_k7/``
    at first use and called through its C entry point: with the card's SM
    count where the build exports a plan (``dfd_attn4d_plan``), without it
    in the one-block-a-query-tile design before."""

    def __init__(self, tree: str):
        self.csrc = Path(tree) / "deepfakedetection_tpu_torch" / "ops" / "csrc"
        self.fn = None
        self.planned = False

    def _entry(self):
        if self.fn is None:
            lib = build_alone(self.csrc, "attn4d.cu")
            self.planned = hasattr(lib, "dfd_attn4d_plan")
            self.fn = lib.dfd_attn4d
            self.fn.argtypes = ([_P] * 9 + [_I] * 5 + [_L] * 6 + ([_I] if self.planned else [])
                                + [_F, _I, _P])
            self.fn.restype = ctypes.c_int
        return self.fn

    def __call__(self, *args, num_heads: int, scale: float):
        fn = self._entry()
        return _launch(fn, self.planned, "dfd_attn4d", *args, num_heads=num_heads, scale=scale)


def _takes_sms(source: str) -> bool:
    """Whether an ``attn4d_long.cu``'s C entry takes the SM count (the
    two-walk design's does, the one-block-a-query-tile design's does not)."""
    entry = re.search(r'extern "C" int dfd_attn4d_long\((.*?)\)\s*\{', source, re.S)
    if entry is None:
        raise ValueError("no dfd_attn4d_long entry in the source")
    return "int sms" in entry.group(1)


class OtherLong:
    """K7's long kernel of the checkout in ``tree`` (its ``attn4d_long.cu``
    built alone, with ``defines``), called through its C entry point with
    the SM count where it takes one; ``takes(shape)`` asks its plan."""

    def __init__(self, tree: str, csrc: Path | None = None, defines: tuple[str, ...] = ()):
        self.csrc = csrc or Path(tree) / "deepfakedetection_tpu_torch" / "ops" / "csrc"
        self.lib = build_alone(self.csrc, "attn4d_long.cu", defines)
        self.sms = _takes_sms((self.csrc / "attn4d_long.cu").read_text())
        self.fn = self.lib.dfd_attn4d_long
        self.fn.argtypes = ([_P] * 9 + [_I] * 5 + [_L] * 6 + ([_I] if self.sms else [])
                            + [_F, _I, _P])
        self.fn.restype = ctypes.c_int
        self.plan = self.lib.dfd_attn4d_long_plan
        self.plan.argtypes = [_I] * (6 if self.sms else 5) + [_P]
        self.plan.restype = ctypes.c_int

    def takes(self, B: int, N: int, h: int, d: int, dv: int, sms: int) -> bool:
        out = (ctypes.c_int * 8)()
        return self.plan(B, N, h, d, dv, *([sms] if self.sms else []), out) == 0

    def __call__(self, *args, num_heads: int, scale: float):
        return _launch(self.fn, self.sms, "dfd_attn4d_long", *args, num_heads=num_heads,
                       scale=scale)


def compare(tree: str, shapes=None, odd=None) -> list[dict]:
    """This checkout's K7 against ``tree``'s: at ``shapes`` (default
    ``chip_smoke.K7_SHAPES``) and ``odd`` (``chip_smoke.K7_ODD``) this one
    within two bf16 steps of the plain version's output scale (raises
    otherwise), the other's largest distance from the plain version in bf16
    steps of that scale, and whether the two outputs are bit-identical; at
    ``shapes`` both timed in turns (``profile_k3.turns``)."""
    import chip_smoke as cs

    from deepfakedetection_tpu_torch.ops import attn4d as k7

    cases = [(s[:5], True) for s in (shapes or cs.K7_SHAPES)]
    cases += [(s, False) for s in (cs.K7_ODD if odd is None else odd)]
    return _compare(Other(tree), tree, "K7", k7.attn4d, KERNELS, cases, seed=800)


def compare_long(tree: str, shapes=None, odd=None) -> list[dict]:
    """This checkout's long K7 kernel against ``tree``'s at every shape of
    ``shapes`` (default ``chip_smoke.K7_LONG_SHAPES``, timed) and ``odd``
    (``K7_LONG_ODD``) that the other's plan takes: as ``compare``, with a
    row a shape and ``ratio`` this device time over the other's; shapes the
    other refuses are left out."""
    import chip_smoke as cs

    from deepfakedetection_tpu_torch.ops import attn4d as k7
    from deepfakedetection_tpu_torch.ops.expand_dw import sm_count

    other, sms = OtherLong(tree), sm_count("cuda")
    cases = [(s[:5], True) for s in (shapes or cs.K7_LONG_SHAPES)]
    cases += [(s, False) for s in (cs.K7_LONG_ODD if odd is None else odd)]
    taken = [(s, timed) for s, timed in cases if other.takes(*s, sms)]
    rows = _compare(other, tree, "K7 long", k7.attn4d, LONG_KERNELS, taken, seed=840)
    for row in rows:
        if "this_device_ms" in row:
            row["ratio"] = row["this_device_ms"] / row["other_device_ms"]
    left = [s for s, _ in cases if (s, True) not in taken and (s, False) not in taken]
    if left:
        print(f"K7 long: {tree}'s kernel refuses {left}", flush=True)
    return rows


def _compare(other, tree: str, label: str, this, kernels, cases, seed: int) -> list[dict]:
    import chip_smoke as cs
    import torch

    from deepfakedetection_tpu_torch.ops import attn4d as k7
    from deepfakedetection_tpu_torch.profile_k3 import turns

    rows = []
    for i, ((B, N, h, d, dv), timed) in enumerate(cases):
        args = cs.k7_inputs(B, N, h, d, dv, seed=seed + i, device="cuda")
        kw = {"num_heads": h, "scale": d**-0.5}
        runs = {"other": lambda: other(*args, **kw), "this": lambda: this(*args, **kw)}
        ref = k7.attn4d_plain(*args, **kw)
        step = cs.two_steps(ref) / 2
        outs = {name: fn() for name, fn in runs.items()}
        torch.cuda.synchronize()
        cs.check_close(f"this {label} {(B, N, h, d, dv)}", outs["this"], ref, 2 * step, 0.0)
        off = float((outs["other"].float() - ref.float()).abs().max())
        row = {"shape": (B, N, h, d, dv),
               "bit_identical": torch.equal(outs["other"], outs["this"]),
               "other_steps_from_plain": off / max(step, 1e-30)}
        if timed:
            row.update(turns(runs, dict.fromkeys(runs, kernels)))
        rows.append(row)
        text = (f"{label} {(B, N, h, d, dv)}: this within two bf16 steps; bit-identical to "
                f"{tree}'s {row['bit_identical']} (the other {row['other_steps_from_plain']:g} "
                "steps from the plain version)")
        if timed:
            text += (f"; ms a call: this {row['this_ms']:.4f} (device "
                     f"{row['this_device_ms']:.4f}), {tree}'s {row['other_ms']:.4f} (device "
                     f"{row['other_device_ms']:.4f}); device ratio "
                     f"{row['this_device_ms'] / row['other_device_ms']:.3f}")
        print(text, flush=True)
    return rows


_TILE_MACROS = """
__device__ unsigned long long dfd_k7_clocks[5];
#define DFD_START long long dfd_last = clock64(); unsigned long long dfd_acc[5] = {};
#define DFD_MARK(i) if (threadIdx.x == 0) { const long long now = clock64(); \\
  dfd_acc[i] += now - dfd_last; dfd_last = now; }
#define DFD_FLUSH if (threadIdx.x == 0) \\
  for (int i = 0; i < 5; ++i) atomicAdd(&dfd_k7_clocks[i], dfd_acc[i]);
"""
_TILE_EDITS = (  # (text, what it becomes) in the one-block-a-query-tile design's source
    ("namespace {\n", "namespace {\n" + _TILE_MACROS),
    ("  const bool bvec = vec != 0;\n", "  const bool bvec = vec != 0;\n  DFD_START\n"),
    ("  // Phase A: raw f32 scores", "  DFD_MARK(0)\n  // Phase A: raw f32 scores"),
    ("  // Phase B: a warp a row.", "  DFD_MARK(1)\n  // Phase B: a warp a row."),
    ("    __syncthreads();  // phase B done (go 0), or every warp done with v_{go-1}\n",
     "    __syncthreads();  // phase B done (go 0), or every warp done with v_{go-1}\n"
     "    DFD_MARK(go == 0 ? 2 : 3)\n"),
    ("    copy_rows(vs, L.ldv, v.p + b * v.sb + go * dv, v.sr, N, dv, bvec);\n",
     "    copy_rows(vs, L.ldv, v.p + b * v.sb + go * dv, v.sr, N, dv, bvec);\n    DFD_MARK(4)\n"),
    ("\n}\n\n}  // namespace", "\n  DFD_MARK(3)\n  DFD_FLUSH\n}\n\n}  // namespace"),
)
_CLOCKS_ENTRY = """
extern "C" int dfd_attn4d_long_clocks(unsigned long long* out) {
  cudaError_t e = cudaMemcpyFromSymbol(out, dfd_k7_clocks, sizeof(dfd_k7_clocks));
  const unsigned long long zero[5] = {};
  if (e == cudaSuccess) e = cudaMemcpyToSymbol(dfd_k7_clocks, zero, sizeof(zero));
  return static_cast<int>(e);
}
"""


def _clocked_csrc(tree: str) -> tuple[Path, tuple[str, ...]]:
    """(csrc directory, defines) of ``tree``'s long kernel with clock laps:
    its own hooks, or for the design without them a patched copy under
    ``build/profile_k7/``."""
    from deepfakedetection_tpu_torch.ops import build

    csrc = Path(tree) / "deepfakedetection_tpu_torch" / "ops" / "csrc"
    text = (csrc / "attn4d_long.cu").read_text()
    if "DFD_K7_CLOCKS" in text:
        return csrc, ("-DDFD_K7_CLOCKS",)
    for old, new in _TILE_EDITS:
        if text.count(old) != 1:
            raise ValueError(f"{tree}'s attn4d_long.cu: {old.strip()[:50]!r} not found once")
        text = text.replace(old, new)
    digest = hashlib.sha256(text.encode()).hexdigest()[:16]
    copy = build.BUILD_DIR.parent / "profile_k7" / f"clocked_{digest}"
    if not copy.exists():
        shutil.copytree(csrc, copy)
        (copy / "attn4d_long.cu").write_text(text + _CLOCKS_ENTRY)
    return copy, ()


def phases(tree: str, shape=None, calls: int = 10) -> dict:
    """``tree``'s long kernel's clock laps at ``shape`` (default S1 at 384
    px, ``chip_smoke.K7_LONG_SHAPES[0]``) over ``calls`` calls after one
    warm call: each phase's cycles a call summed over the blocks' counting
    threads, and its share of its thread's total (the two-walk design: the
    consumer's three phases of theirs, the producer's two of its)."""
    import chip_smoke as cs
    import torch

    csrc, defines = _clocked_csrc(tree)
    kernel = OtherLong(tree, csrc=csrc, defines=defines)
    B, N, h, d, dv = (shape or cs.K7_LONG_SHAPES[0])[:5]
    args = cs.k7_inputs(B, N, h, d, dv, seed=860, device="cuda")
    read = kernel.lib.dfd_attn4d_long_clocks
    read.argtypes, read.restype = [_P], ctypes.c_int
    counts = (ctypes.c_ulonglong * 8)()
    kernel(*args, num_heads=h, scale=d**-0.5)
    torch.cuda.synchronize()
    read(counts)
    for _ in range(calls):
        kernel(*args, num_heads=h, scale=d**-0.5)
    torch.cuda.synchronize()
    if read(counts):
        raise RuntimeError(f"{tree}: reading the clock counters failed")
    names = PHASES if kernel.sms else TILE_PHASES
    cycles = {name: counts[i] / calls for i, name in enumerate(names)}
    groups = [names[:5], names[5:]] if kernel.sms else [names]
    shares = {}
    for group in groups:
        total = sum(cycles[name] for name in group) or 1.0
        shares.update({name: cycles[name] / total for name in group})
    print(f"K7 long phases, {tree}, {(B, N, h, d, dv)}: "
          + ", ".join(f"{name} {shares[name]:.1%}" for name in names), flush=True)
    return {"tree": tree, "shape": (B, N, h, d, dv), "cycles_a_call": cycles, "shares": shares}


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", required=True, action="append",
                        help="compare with the K7 of the checkout in this directory (repeatable)")
    parser.add_argument("--long", action="store_true",
                        help="compare the long kernels and split each by phase")
    args = parser.parse_args()
    import chip_smoke as cs
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_k7: no CUDA card")
    print(cs.smi(), flush=True)
    for tree in args.tree:
        if args.long:
            compare_long(tree)
            phases(tree)
        else:
            compare(tree)
    if args.long:
        phases(".")


if __name__ == "__main__":
    main()
