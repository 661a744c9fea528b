"""K4 (``ops/csrc/shear_rotate.cu``, the three-shear rotation) against another
checkout's, on one CUDA card, at ``chip_smoke.K4_CASES``. Run from the
repository root:

    python -m deepfakedetection_tpu_torch.profile_k4 --tree DIR [--tree DIR ...]

It builds the K4 of another checkout (say the parent commit, unpacked with
``git archive`` into a directory ``.gitignore`` lists) from its
``shear_rotate.cu`` alone, runs the same images and angles through both at
every case (this checkout's held to the plain version bit for bit; whether
the two outputs are bit-identical reported) and times both at the B3
fine-tune canvas, ``K4_CASES[0]``, in turns (other, this, this, other), by
CUDA events and by the device time of their kernels. The other tree's K4 is
either this design (one fused launch, ``dfd_shear_rotate``) or the one
before it (three launches of one pass each, ``dfd_shear_pass``).
``chip_smoke.py --parent DIR`` runs this comparison in its phase 1 and
requires bit-identical outputs.

``--ablate`` times, in turns at ``K4_CASES[0]``, copies of this checkout's
``shear_rotate.cu`` built under ``build/profile_k4/ablate/`` with the later
phases removed (pass 3; passes 2 and 3; all passes; the staging as well), so
each phase's share is a difference, and a 16-byte copy of the canvas (read
once, written once: the practical floor). With ``--tree DIR`` it also times
that checkout's three-launch design whole, one x-shear pass, one y-shear
pass, and the coefficients' PyTorch kernels.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import hashlib
import statistics
import subprocess
from pathlib import Path

KERNELS = ("shear_rotate_kernel",)  # this design's device kernel, as the profiler names it
PASS_KERNELS = ("shear_pass_kernel",) * 3  # the design before: one launch a pass


class Other:
    """K4 of the checkout in ``tree``, built alone into ``build/profile_k4/``
    at first use and called through its C entry point, in either design."""

    def __init__(self, tree: str):
        self.csrc = Path(tree) / "deepfakedetection_tpu_torch" / "ops" / "csrc"
        self.lib = None

    def _load(self):
        from deepfakedetection_tpu_torch.ops import build

        if self.lib is None:
            digest = hashlib.sha256(" ".join(build.NVCC_FLAGS).encode())
            digest.update((self.csrc / "shear_rotate.cu").read_bytes())
            out = build.BUILD_DIR.parent / "profile_k4" / f"k4_{digest.hexdigest()[:16]}.so"
            if not out.exists():
                out.parent.mkdir(parents=True, exist_ok=True)
                subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(out),
                                str(self.csrc / "shear_rotate.cu")], check=True)
            self.lib = ctypes.CDLL(str(out))
            P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            if hasattr(self.lib, "dfd_shear_rotate"):
                self.lib.dfd_shear_rotate.argtypes = build._SIGNATURES["dfd_shear_rotate"]
            else:
                self.lib.dfd_shear_pass.argtypes = [P] * 3 + [I] * 4 + [F] + [I] * 3 + [P]
        return self.lib

    @property
    def kernels(self) -> tuple[str, ...]:
        return KERNELS if hasattr(self._load(), "dfd_shear_rotate") else PASS_KERNELS

    def __call__(self, imgs, thetas, *, max_theta: float):
        import torch

        from deepfakedetection_tpu_torch.ops.shear_rotate import ROWS_PER_BLOCK, _passes

        lib = self._load()
        B, H, W, C = imgs.shape
        stream = torch.cuda.current_stream().cuda_stream
        passes = _passes(thetas, H, W, max_theta)
        if hasattr(lib, "dfd_shear_rotate"):
            (a, cy, taps_x, _), (b, cx, taps_y, _), _ = passes
            y = torch.empty_like(imgs)
            rc = lib.dfd_shear_rotate(imgs.data_ptr(), y.data_ptr(), a.data_ptr(), b.data_ptr(),
                                      B, H, W, C, cy, cx, taps_x, taps_y, stream)
            if rc:
                raise RuntimeError(f"the other tree's dfd_shear_rotate failed: CUDA error {rc}")
            return y
        x = imgs
        for coef, center, taps, along_h in passes:
            y = torch.empty_like(x)
            rc = lib.dfd_shear_pass(x.data_ptr(), y.data_ptr(), coef.data_ptr(), B, H, W, C,
                                    center, ROWS_PER_BLOCK, taps, int(along_h), stream)
            if rc:
                raise RuntimeError(f"the other tree's dfd_shear_pass failed: CUDA error {rc}")
            x = y
        return x


def compare(tree: str, cases=None) -> list[dict]:
    """This checkout's K4 against ``tree``'s at ``cases`` (default
    ``chip_smoke.K4_CASES``): this one bit-identical to the plain version
    (raises otherwise), whether the two outputs are bit-identical, and at
    the first case both timed in turns (``profile_k3.turns``)."""
    import chip_smoke as cs
    import torch

    from deepfakedetection_tpu_torch.ops import shear_rotate as k4
    from deepfakedetection_tpu_torch.profile_k3 import turns

    other, rows = Other(tree), []
    for i, (B, H, W, max_theta, largest) in enumerate(cases or cs.K4_CASES):
        x, thetas = cs.k4_inputs(B, H, W, largest, seed=400 + i, device="cuda")
        runs = {"other": lambda: other(x, thetas, max_theta=max_theta),
                "this": lambda: k4.rotate_batch(x, thetas, max_theta=max_theta)}
        outs = {name: fn() for name, fn in runs.items()}
        torch.cuda.synchronize()
        if not torch.equal(outs["this"], k4.rotate_batch_plain(x, thetas, max_theta=max_theta)):
            raise AssertionError(f"this K4 {(B, H, W)}: not the plain version's output")
        row = {"shape": (B, H, W, 3), "max_theta": max_theta,
               "bit_identical": torch.equal(outs["other"], outs["this"])}
        if i == 0:
            row.update(turns(runs, {"other": other.kernels, "this": KERNELS}))
        rows.append(row)
        text = (f"K4 {(B, H, W, 3)} max_theta {max_theta}: this is the plain version's output; "
                f"bit-identical to {tree}'s {row['bit_identical']}")
        if i == 0:
            text += (f"; ms a call: this {row['this_ms']:.4f} (device "
                     f"{row['this_device_ms']:.4f}), {tree}'s {row['other_ms']:.4f} (device "
                     f"{row['other_device_ms']:.4f}); device ratio "
                     f"{row['this_device_ms'] / row['other_device_ms']:.3f}")
        print(text, flush=True)
    return rows


# ablated copies: each removes the loop of one phase and those after it
_LOOPS = {"pass 3": "for (int it = tid; it < tw * G3; it += NT) {",
          "pass 2": "for (int it = tid; it < W2 * G2; it += NT) {",
          "pass 1": "for (int it = tid; it < W2 * G1; it += NT) {",
          "staging": "for (int it = tid; it < nseg * H1 * maxch; it += NT) {"}
_COPY = """#include <cstdint>
#include <cuda_runtime.h>
__global__ void copy16_kernel(const uint4* __restrict__ x, uint4* __restrict__ y, long long n) {
  for (long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) y[i] = x[i];
}
extern "C" int dfd_copy16(const void* x, void* y, long long bytes, void* stream) {
  copy16_kernel<<<132 * 8, 256, 0, (cudaStream_t)stream>>>((const uint4*)x, (uint4*)y, bytes / 16);
  return (int)cudaGetLastError();
}
"""


def _ablated_sources() -> dict[str, str]:
    from deepfakedetection_tpu_torch.ops import build

    src = (build.CSRC / "shear_rotate.cu").read_text()
    out, cut = {"whole kernel": src}, src
    for name, loop in _LOOPS.items():
        if cut.count(loop) != 1:
            raise RuntimeError(f"shear_rotate.cu changed: no single loop {loop!r}")
        bound = loop.split("< ")[1].split(";")[0]
        cut = cut.replace(loop, loop.replace(f"< {bound};", f"< {bound} * 0;"))
        out[f"without {name}" + (" and after" if name != "pass 3" else "")] = cut
    return out


def _lib(name: str, text: str) -> ctypes.CDLL:
    from deepfakedetection_tpu_torch.ops import build

    d = build.BUILD_DIR.parent / "profile_k4" / "ablate" / name.replace(" ", "_")
    d.mkdir(parents=True, exist_ok=True)
    (d / "k.cu").write_text(text)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(d / "k.so"),
                    str(d / "k.cu")], check=True)
    return ctypes.CDLL(str(d / "k.so"))


def ablate(tree: str | None = None) -> dict[str, float]:
    """Device ms a call at ``K4_CASES[0]`` of each ablated copy, the 16-byte
    copy and (with ``tree``) the other design's pieces, in turns (the list,
    then the list backwards, twice; ``chip_smoke.launch_ms``)."""
    import chip_smoke as cs
    import torch

    from deepfakedetection_tpu_torch.ops import build
    from deepfakedetection_tpu_torch.ops.shear_rotate import ROWS_PER_BLOCK, _passes

    texts = {**_ablated_sources(), "16-byte copy": _COPY}
    with concurrent.futures.ThreadPoolExecutor(len(texts)) as pool:
        libs = dict(zip(texts, pool.map(_lib, texts, texts.values())))
    B, H, W, max_theta, largest = cs.K4_CASES[0]
    x, thetas = cs.k4_inputs(B, H, W, largest, seed=300, device="cuda")
    y = torch.empty_like(x)
    passes = _passes(thetas, H, W, max_theta)
    (a, cy, taps_x, _), (b, cx, taps_y, _), _ = passes
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    runs = {}
    for name, lib in libs.items():
        if name == "16-byte copy":
            lib.dfd_copy16.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_longlong, ctypes.c_void_p]
            runs[name] = (lambda lib=lib: lib.dfd_copy16(x.data_ptr(), y.data_ptr(),
                                                         2 * x.numel(), stream()),
                          ("copy16_kernel",))
            continue
        lib.dfd_shear_rotate.argtypes = build._SIGNATURES["dfd_shear_rotate"]
        runs[name] = (lambda lib=lib: lib.dfd_shear_rotate(
            x.data_ptr(), y.data_ptr(), a.data_ptr(), b.data_ptr(), B, H, W, 3, cy, cx, taps_x,
            taps_y, stream()), KERNELS)
    if tree is not None:
        other = Other(tree)
        runs[f"{tree}'s rotation"] = (lambda: other(x, thetas, max_theta=max_theta),
                                      other.kernels)
        if not hasattr(other._load(), "dfd_shear_rotate"):
            for i, label in ((0, "x-shear pass"), (1, "y-shear pass")):
                coef, center, taps, along_h = passes[i]
                runs[f"{tree}'s {label}"] = (lambda coef=coef, center=center, taps=taps,
                                             along_h=along_h: other.lib.dfd_shear_pass(
                    x.data_ptr(), y.data_ptr(), coef.data_ptr(), B, H, W, 3, center,
                    ROWS_PER_BLOCK, taps, int(along_h), stream()), PASS_KERNELS[:1])
    dev = {name: [] for name in runs}
    for _ in range(2):
        for name in list(runs) + list(runs)[::-1]:
            fn, kernels = runs[name]
            dev[name].append(cs.launch_ms(fn, kernels))
    out = {name: statistics.mean(v) for name, v in dev.items()}
    if tree is not None:
        out["the coefficients' PyTorch kernels"] = sum(cs.kernel_split(
            lambda: _passes(thetas, H, W, max_theta), calls=25)[0].values())
    for name, ms in out.items():
        print(f"K4 {(B, H, W, 3)} {name}: {ms:.4f} ms of device time a call", flush=True)
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", action="append", default=[],
                        help="compare with the K4 of the checkout in this directory (repeatable)")
    parser.add_argument("--ablate", action="store_true",
                        help="time ablated copies of this K4 (and the --tree's pieces)")
    args = parser.parse_args()
    import chip_smoke as cs
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_k4: no CUDA card")
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
