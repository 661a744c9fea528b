"""K1 (``ops/csrc/depthwise_se.cu``, B3's stage-0 depthwise + SiLU + SE pool)
against another checkout's, on one CUDA card, at ``chip_smoke.K1_SHAPES``
(batch 128) and ``chip_smoke.K1_ODD`` (batch 8). Run from the repository
root:

    python -m deepfakedetection_tpu_torch.profile_k1 --tree DIR [--tree DIR ...]

It builds the K1 of another checkout (say the parent commit, unpacked with
``git archive`` into a directory ``.gitignore`` lists) from its
``depthwise_se.cu`` and the headers it includes, and from nothing else, runs
the same operands through both entry points at every shape (this checkout's
held to the plain version within ``chip_smoke.K1_TOL`` and its y and pool
repeating bit for bit; whether the two y are bit-identical and how far apart
the two pools are, relative to the pool's scale) and times both at the B3
shapes in turns (other, this, this, other), by CUDA events and by the device
time of their kernels. The other tree's K1 is either this design (a
persistent kernel, ``dfd_depthwise_plan`` exported) or the one before it
(16 x 16 tiles, a partial-sum scratch and a second kernel, ``pool_finalize``,
adding the tiles). ``chip_smoke.py --parent DIR`` runs this comparison in its
phase 1 and requires bit-identical y.

``--ablate`` times, in turns at both B3 shapes, copies of this checkout's
``depthwise_se.cu`` built under ``build/profile_k1/ablate/``: whole, with the
SiLU's fast quotient kept everywhere (unguarded: y then differs), without the
y stores, and with the copies alone (no taps); and 16-byte copy and store
kernels over the same bytes (the practical floors). With ``--tree DIR`` of a
checkout in the tiled design it also times that kernel whole, without its
SiLU, with the SiLU alone (one tap), with its staging alone, and its
``pool_finalize``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import hashlib
import importlib.util
import statistics
import subprocess
import sys
from pathlib import Path

KERNELS = ("depthwise_silu_pool_kernel",)  # this design's device kernel, as the profiler names it


class Other:
    """K1 of the checkout in ``tree``, built alone into ``build/profile_k1/``
    at first use and called through its C entry point, in either design."""

    def __init__(self, tree: str):
        self.csrc = Path(tree) / "deepfakedetection_tpu_torch" / "ops" / "csrc"
        self.lib = None
        self.mod = None
        self.kernels = KERNELS

    def _load(self):
        from deepfakedetection_tpu_torch.ops import build

        if self.lib is None:
            digest = hashlib.sha256(" ".join(build.NVCC_FLAGS).encode())
            for src in sorted(self.csrc.glob("*.cu*")):
                digest.update(src.read_bytes())
            out = build.BUILD_DIR.parent / "profile_k1" / f"k1_{digest.hexdigest()[:16]}.so"
            if not out.exists():
                out.parent.mkdir(parents=True, exist_ok=True)
                subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(out),
                                str(self.csrc / "depthwise_se.cu")], check=True)
            self.lib = ctypes.CDLL(str(out))
            P, I = ctypes.c_void_p, ctypes.c_int
            if hasattr(self.lib, "dfd_depthwise_plan"):
                self.lib.dfd_depthwise_silu_pool.argtypes = [P] * 5 + [I] * 5 + [P]
            else:  # the tiled design: its Python plan, a scratch, and pool_finalize
                self.lib.dfd_depthwise_silu_pool.argtypes = [P] * 6 + [I] * 8 + [P]
                spec = importlib.util.spec_from_file_location(
                    "other_depthwise_se", self.csrc.parent / "depthwise_se.py")
                self.mod = importlib.util.module_from_spec(spec)
                sys.modules[spec.name] = self.mod  # its dataclasses look their module up
                spec.loader.exec_module(self.mod)
            self.lib.dfd_depthwise_silu_pool.restype = I
        return self.lib

    def __call__(self, x, w, b, *, k: int):
        import torch

        lib = self._load()
        B, H, W, C = x.shape
        y = torch.empty_like(x)
        pool = torch.empty(B, C, dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [t.data_ptr() for t in (x, w, b, y)]
        if self.mod is None:
            rc = lib.dfd_depthwise_silu_pool(*ptrs, pool.data_ptr(), B, H, W, C, k, stream)
        else:
            p = self.mod.plan(H, W, C, k)
            partial = torch.empty(B, p.tiles, C, dtype=torch.float32, device=x.device)
            rc = lib.dfd_depthwise_silu_pool(*ptrs, partial.data_ptr(), pool.data_ptr(), B, H, W,
                                             C, k, p.TH, p.TW, p.CB, stream)
        if rc:
            raise RuntimeError(f"the other tree's dfd_depthwise_silu_pool failed: CUDA error {rc}")
        return y, pool

    def device_kernels(self, call) -> tuple[str, ...]:
        """The kernels one call launches, as ``chip_smoke.launch_ms`` names
        them: the tiled design's second kernel by its profiler key."""
        import chip_smoke as cs

        if self.mod is None:
            return KERNELS
        split = cs.kernel_split(call, calls=5, expect=KERNELS)[0]
        return KERNELS + tuple(name for name in split if "pool_finalize" in name)


def compare(tree: str, shapes=None, odd=None) -> list[dict]:
    """This checkout's K1 against ``tree``'s: at ``shapes`` (default
    ``chip_smoke.K1_SHAPES``, batch 128) and ``odd`` (``chip_smoke.K1_ODD``,
    batch 8) this one within ``chip_smoke.K1_TOL`` of the plain version and
    repeating bit for bit (raises otherwise), whether the two y are
    bit-identical and the largest pool difference relative to the pool's
    scale; at ``shapes`` both timed in turns (``profile_k3.turns``)."""
    import chip_smoke as cs
    import torch

    from deepfakedetection_tpu_torch.ops import depthwise_se as k1
    from deepfakedetection_tpu_torch.profile_k3 import turns

    other, rows = Other(tree), []
    cases = [(s, 128, True) for s, _ in (shapes or cs.K1_SHAPES)]
    cases += [(s, 8, False) for s in (cs.K1_ODD if odd is None else odd)]
    for i, ((H, W, C, k), B, timed) in enumerate(cases):
        args = cs.k1_inputs(B, H, W, C, k, seed=500 + i, device="cuda")
        runs = {"other": lambda: other(*args, k=k),
                "this": lambda: k1.depthwise_silu_pool(*args, k=k)}
        outs = {name: fn() for name, fn in runs.items()}
        again = runs["this"]()
        torch.cuda.synchronize()
        if not (torch.equal(again[0], outs["this"][0]) and torch.equal(again[1], outs["this"][1])):
            raise AssertionError(f"this K1 {(B, H, W, C, k)}: two runs differ")
        ry, rpool = k1.depthwise_silu_pool_plain(*args, k=k)
        cs.check_close(f"this K1 {(B, H, W, C, k)} y", outs["this"][0], ry, *cs.K1_TOL["y"])
        cs.check_close(f"this K1 {(B, H, W, C, k)} pool", outs["this"][1], rpool,
                       *cs.K1_TOL["pool"])
        scale = float(rpool.abs().max())
        row = {"shape": (H, W, C, k), "batch": B,
               "y_bit_identical": torch.equal(outs["other"][0], outs["this"][0]),
               "pool_rel_diff": float((outs["other"][1] - outs["this"][1]).abs().max())
               / max(scale, 1e-30)}
        if timed:
            row.update(turns(runs, {"other": other.device_kernels(runs["other"]),
                                    "this": KERNELS}))
        rows.append(row)
        text = (f"K1 {(B, H, W, C, k)}: this within K1_TOL, repeating bit for bit; y "
                f"bit-identical to {tree}'s {row['y_bit_identical']}, pools "
                f"{row['pool_rel_diff']:.2e} of the scale apart")
        if timed:
            text += (f"; ms a call: this {row['this_ms']:.4f} (device "
                     f"{row['this_device_ms']:.4f}), {tree}'s {row['other_ms']:.4f} (device "
                     f"{row['other_device_ms']:.4f}); device ratio "
                     f"{row['this_device_ms'] / row['other_device_ms']:.3f}")
        print(text, flush=True)
    return rows


# ablated copies of this design: (marker, replacement)
_THIS = {"fast SiLU everywhere": ("exact = exact &&", "exact = exact ||"),
         "without y stores": ("*reinterpret_cast<uint2*>(dst) = make_uint2(w0, w1);",
                              "if (w0 == 0x12345678u) *reinterpret_cast<uint2*>(dst) = "
                              "make_uint2(w0, w1);"),
         "copies alone": ("for (; c < C && 4 * g < p.CB && yy < ohi;",
                          "for (; c < C && H < 0 && 4 * g < p.CB && yy < ohi;")}
# ... and of the tiled design's depthwise_se.cu
_TILED = {
    "tiled: without SiLU": ("__float2bfloat16_rn(dfd::silu(acc))", "__float2bfloat16_rn(acc)"),
    "tiled: SiLU alone": (
        "const float acc = dfd::dw_taps<K>(halo, WW, CB, lane, py, px, wr) + bv;",
        "const float acc = bf2f(halo[((py + 1) * WW + px + 1) * CB + lane]) * wr[4] + bv;"),
    "tiled: staging alone": ("  const int c = c0 + lane;\n  float psum = 0.0f;\n  if (c < C) {",
                             "  const int c = c0 + lane;\n  float psum = 0.0f;\n"
                             "  if (c < C && H < 0) {")}
_FLOORS = """#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
__global__ void copy16_kernel(const uint4* __restrict__ x, uint4* __restrict__ y, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) y[i] = x[i];
}
__global__ void store2_kernel(__nv_bfloat16* __restrict__ y, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) y[i] = __float2bfloat16(1.0f);
}
__global__ void store16_kernel(uint4* __restrict__ y, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) y[i] = make_uint4(1, 2, 3, 4);
}
extern "C" int dfd_floor(int which, const void* x, void* y, long long bytes, void* s) {
  cudaStream_t st = (cudaStream_t)s;
  if (which == 0) copy16_kernel<<<132 * 8, 256, 0, st>>>((const uint4*)x, (uint4*)y, bytes / 16);
  if (which == 1) store2_kernel<<<132 * 8, 256, 0, st>>>((__nv_bfloat16*)y, bytes / 2);
  if (which == 2) store16_kernel<<<132 * 8, 256, 0, st>>>((uint4*)y, bytes / 16);
  return (int)cudaGetLastError();
}
"""


def _lib(name: str, text: str, headers: Path) -> ctypes.CDLL:
    from deepfakedetection_tpu_torch.ops import build

    d = build.BUILD_DIR.parent / "profile_k1" / "ablate" / "".join(
        ch if ch.isalnum() else "_" for ch in name)
    d.mkdir(parents=True, exist_ok=True)
    (d / "k.cu").write_text(text)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(headers), "-shared", "-o",
                    str(d / "k.so"), str(d / "k.cu")], check=True)
    return ctypes.CDLL(str(d / "k.so"))


def ablate(tree: str | None = None) -> dict:
    """Device ms a call of each copy at each B3 shape, in turns (the list,
    then the list backwards, twice; ``chip_smoke.launch_ms``)."""
    import chip_smoke as cs
    import torch

    from deepfakedetection_tpu_torch.ops import build

    src = (build.CSRC / "depthwise_se.cu").read_text()
    texts, headers = {"whole kernel": src}, {}
    for name, (a, b) in _THIS.items():
        if src.count(a) != 1:
            raise RuntimeError(f"depthwise_se.cu changed: no single {a!r}")
        texts[name] = src.replace(a, b)
    texts["floors"] = _FLOORS
    headers = dict.fromkeys(texts, build.CSRC)
    other = Other(tree) if tree is not None else None
    if other is not None and (other._load() and other.mod is not None):  # the tiled design
        tiled = (other.csrc / "depthwise_se.cu").read_text()
        texts["tiled: whole kernel"], headers["tiled: whole kernel"] = tiled, other.csrc
        for name, (a, b) in _TILED.items():
            if tiled.count(a) == 1:
                texts[name], headers[name] = tiled.replace(a, b), other.csrc
    with concurrent.futures.ThreadPoolExecutor(len(texts)) as pool:
        libs = dict(zip(texts, pool.map(_lib, texts, texts.values(), headers.values())))
    P, I = ctypes.c_void_p, ctypes.c_int
    out = {}
    for (H, W, C, k), _ in cs.K1_SHAPES:
        x, w, b = cs.k1_inputs(128, H, W, C, k, seed=200, device="cuda")
        y = torch.empty_like(x)
        pool = torch.empty(128, C, dtype=torch.float32, device="cuda")
        stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
        runs = {}
        for name, lib in libs.items():
            fn = lib.dfd_floor if name == "floors" else lib.dfd_depthwise_silu_pool
            if name == "floors":
                fn.argtypes = [I, P, P, ctypes.c_longlong, P]
                for which, label, kern in ((0, "16-byte copy of x", "copy16_kernel"),
                                           (1, "2-byte stores of y", "store2_kernel"),
                                           (2, "16-byte stores of y", "store16_kernel")):
                    runs[label] = (lambda fn=fn, which=which: fn(
                        which, x.data_ptr(), y.data_ptr(), 2 * x.numel(), stream()), (kern,))
            elif name.startswith("tiled"):
                p = other.mod.plan(H, W, C, k)
                part = torch.empty(128, p.tiles, C, dtype=torch.float32, device="cuda")
                fn.argtypes = [P] * 6 + [I] * 8 + [P]
                runs[name] = (lambda fn=fn, p=p, part=part: fn(
                    x.data_ptr(), w.data_ptr(), b.data_ptr(), y.data_ptr(), part.data_ptr(),
                    pool.data_ptr(), 128, H, W, C, k, p.TH, p.TW, p.CB, stream()), KERNELS)
            else:
                fn.argtypes = build._SIGNATURES["dfd_depthwise_silu_pool"]
                runs[name] = (lambda fn=fn: fn(x.data_ptr(), w.data_ptr(), b.data_ptr(),
                                               y.data_ptr(), pool.data_ptr(), 128, H, W, C, k,
                                               stream()), KERNELS)
        dev = {name: [] for name in runs}
        for _ in range(2):
            for name in list(runs) + list(runs)[::-1]:
                fn, kernels = runs[name]
                dev[name].append(cs.launch_ms(fn, kernels))
        row = {name: statistics.mean(v) for name, v in dev.items()}
        if "tiled: whole kernel" in runs:
            split = cs.kernel_split(runs["tiled: whole kernel"][0], calls=25)[0]
            row["tiled: pool_finalize"] = sum(v for n, v in split.items() if "pool_finalize" in n)
        for name, ms in row.items():
            print(f"K1 {(128, H, W, C, k)} {name}: {ms:.4f} ms of device time a call", flush=True)
        out[(H, W, C, k)] = row
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", action="append", default=[],
                        help="compare with the K1 of the checkout in this directory (repeatable)")
    parser.add_argument("--ablate", action="store_true",
                        help="time ablated copies of this K1 (and the --tree's pieces)")
    args = parser.parse_args()
    import chip_smoke as cs
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_k1: no CUDA card")
    print(cs.smi(), flush=True)
    if args.ablate:
        for tree in args.tree or [None]:
            ablate(tree)
        return
    if not args.tree:
        parser.error("--tree is required without --ablate")
    for tree in args.tree:
        compare(tree)


if __name__ == "__main__":
    main()
