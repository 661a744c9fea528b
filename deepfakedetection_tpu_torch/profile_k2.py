"""K2 (``ops/csrc/expand_dw.cu``) on one CUDA card at ``chip_smoke.K2_SHAPES``
(EfficientNet-B3's stride-1 expand blocks at batch 128). Run from the
repository root:

    python -m deepfakedetection_tpu_torch.profile_k2              # times a shape
    python -m deepfakedetection_tpu_torch.profile_k2 --tree DIR   # ... against DIR's K2
    python -m deepfakedetection_tpu_torch.profile_k2 --plans      # every plan that fits
    python -m deepfakedetection_tpu_torch.profile_k2 --silu       # K2's SiLU variants

The default times ``expand_dw_silu_pool`` as ``chip_smoke.phase1`` does (CUDA
events, median of 25) with its bound, the bytes it must move over its time,
and each of its kernels' device time (``torch.profiler``). ``--tree DIR``
builds the K2 of another checkout (say the parent commit, unpacked with
``git archive`` into a directory ``.gitignore`` lists) from its
``expand_dw.cu`` alone, runs the same operands through both entry points at
every shape (outputs bit-identical or not, each against the plain version
within ``chip_smoke.K2_TOL``) and times them in turns (other, this, this,
other), by CUDA events and by device time. ``--plans`` times every launch
plan (CB, RB) that fits at each shape through the entry point, which takes
the plan from its caller, each checked against the plain version, beside the
one ``plan`` picks.
``--silu`` builds copies of ``expand_dw.cu`` (with ``depthwise_se.cu``, K1,
beside it) under ``build/profile_k2/silu_<name>/`` that differ only in the
SiLU of both stages (``SILUS``: the precise ``expf`` and IEEE division, the
shipped fast ``__expf`` and ``__fdividef``, and the two mixtures), and for
each: at every B3 shape (batch 128) the share of y's bf16 elements that
differ from the precise build's, the largest error of y in bf16 steps and of
the pool against the plain version computed in f32 (TF32 off, y unrounded;
a step is that of each element, floored at 2**-8 of y's scale),
K2's time per B3 forward, and ``chip_smoke.phase3``'s 16-image check against
the CPU with that build serving K1 and K2.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import hashlib
import importlib.util
import itertools
import statistics
import subprocess
import sys
from pathlib import Path


# K2's device kernels, by the names the profiler records
KERNELS = ("pack_wexp_kernel", "expand_dw_kernel")


def _inputs(shape, seed, device, B=128):
    import chip_smoke as cs

    return cs.k2_inputs(B, *shape, seed=seed, device=device)


class Other:
    """The K2 of the checkout in ``tree``: its ``expand_dw.cu`` built alone
    into ``build/profile_k2/<hash>.so``, its Python plan, and a call through
    its C entry point (the earlier tiled convention, tiles and a partial-sum
    scratch, or this one's, CB and RB and a weight scratch)."""

    def __init__(self, tree: str):
        from deepfakedetection_tpu_torch.ops import build

        csrc = Path(tree) / "deepfakedetection_tpu_torch" / "ops" / "csrc"
        digest = hashlib.sha256(" ".join(build.NVCC_FLAGS).encode())
        for src in sorted(csrc.glob("*.cu*")):
            digest.update(src.read_bytes())
        out = build.BUILD_DIR.parent / "profile_k2" / f"k2_{digest.hexdigest()[:16]}.so"
        if not out.exists():
            out.parent.mkdir(parents=True, exist_ok=True)
            subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(out),
                            str(csrc / "expand_dw.cu")], check=True)
        self.lib = ctypes.CDLL(str(out))
        spec = importlib.util.spec_from_file_location(
            "other_expand_dw", csrc.parent / "expand_dw.py")
        self.mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = self.mod  # its dataclasses look their module up
        spec.loader.exec_module(self.mod)
        self.tiled = "TH" in self.mod.Plan.__dataclass_fields__
        P, I = ctypes.c_void_p, ctypes.c_int
        self.lib.dfd_expand_dw_silu_pool.argtypes = build._SIGNATURES["dfd_expand_dw_silu_pool"]
        if self.tiled:
            self.lib.dfd_expand_dw_silu_pool.argtypes = [P] * 8 + [I] * 9 + [P]
        self.lib.dfd_expand_dw_silu_pool.restype = I

    def __call__(self, x, wexp, bexp, wdw, bdw, k):
        import torch

        B, H, W, Cin = x.shape
        Ce = wexp.shape[1]
        y = torch.empty(B, H, W, Ce, dtype=torch.bfloat16, device=x.device)
        pool = torch.empty(B, Ce, dtype=torch.float32, device=x.device)
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [t.data_ptr() for t in (x, wexp, bexp, wdw, bdw, y)]
        if self.tiled:
            p = self.mod.plan(H, W, Cin, Ce, k)
            partial = torch.empty(B, p.tiles, Ce, dtype=torch.float32, device=x.device)
            rc = self.lib.dfd_expand_dw_silu_pool(*ptrs, partial.data_ptr(), pool.data_ptr(), B, H,
                                                  W, Cin, Ce, k, p.TH, p.TW, p.CB, stream)
        else:
            p = self.mod.plan(H, W, Cin, Ce, k, B, self.mod.sm_count(x.device))
            wpack = torch.empty(self.mod.wpack_words(Cin, Ce), dtype=torch.int32, device=x.device)
            rc = self.lib.dfd_expand_dw_silu_pool(*ptrs, pool.data_ptr(), wpack.data_ptr(), B, H,
                                                  W, Cin, Ce, k, p.CB, p.RB, stream)
        if rc:
            raise RuntimeError(f"the other tree's dfd_expand_dw_silu_pool failed: CUDA error {rc}")
        return y, pool


def compare(tree: str, shapes=None) -> list[dict]:
    """This checkout's K2 against ``tree``'s at ``shapes`` (default
    ``chip_smoke.K2_SHAPES``): both held to the plain version within
    ``K2_TOL``, whether their outputs are bit-identical, and each one's time
    (median of 13 calls in each of the turns other, this, this, other) and,
    where both launch ``KERNELS``, its device time (``chip_smoke.launch_ms``
    in each of the same turns, the mean)."""
    import chip_smoke as cs
    import torch

    from deepfakedetection_tpu_torch.ops import expand_dw as k2

    other, rows = Other(tree), []
    for i, (shape, _) in enumerate(shapes or cs.K2_SHAPES):
        args, k = _inputs(shape, 200 + i, "cuda"), shape[-1]
        runs = {"other": lambda: other(*args, k), "this": lambda: k2.expand_dw_silu_pool(
            *args, kernel=k)}
        ry, rpool = k2.expand_dw_silu_pool_plain(*args, kernel=k)
        outs = {}
        for name, fn in runs.items():
            outs[name] = fn()
            cs.check_close(f"{name} K2 {shape} y", outs[name][0], ry, *cs.K2_TOL["y"])
            cs.check_close(f"{name} K2 {shape} pool", outs[name][1], rpool, *cs.K2_TOL["pool"])
        ms = {name: [] for name in runs}
        dev = {name: [] for name in runs}
        for name in ("other", "this", "this", "other"):
            ms[name] += cs.cuda_times(runs[name], runs=13)
            if not other.tiled:  # the same two kernels in both
                dev[name].append(cs.launch_ms(runs[name], KERNELS))
        row = {"shape": shape, "bit_identical": all(torch.equal(a, b) for a, b in
                                                     zip(outs["other"], outs["this"])),
               **{f"{name}_ms": statistics.median(t) for name, t in ms.items()},
               **{f"{name}_device_ms": statistics.mean(t) for name, t in dev.items() if t}}
        rows.append(row)
        text = (f"K2 {shape}: within K2_TOL both; bit-identical to {tree}'s "
                f"{row['bit_identical']}; ms a call: this {row['this_ms']:.4f}, {tree}'s "
                f"{row['other_ms']:.4f}")
        if dev["this"]:
            text += (f"; device ms a call: this {row['this_device_ms']:.4f}, {tree}'s "
                     f"{row['other_device_ms']:.4f}")
        print(text, flush=True)
    return rows


def times() -> None:
    import chip_smoke as cs

    from deepfakedetection_tpu_torch.ops import expand_dw as k2

    total = {"ms": 0.0, "bound": 0.0}
    for i, (shape, count) in enumerate(cs.K2_SHAPES):
        args, k = _inputs(shape, 200 + i, "cuda"), shape[-1]
        H, W, Cin, Ce, _ = shape
        p = k2.plan(H, W, Cin, Ce, k, 128, k2.sm_count(args[0].device))
        ms = statistics.median(cs.cuda_times(lambda: k2.expand_dw_silu_pool(*args, kernel=k),
                                             runs=25))
        b_ms, by = cs.kernel_bound("expand_dw_silu_pool", 128, shape)
        split = cs.kernel_split(lambda: k2.expand_dw_silu_pool(*args, kernel=k),
                                expect=("pack_wexp_kernel", "expand_dw_kernel"))[0]
        total["ms"] += count * ms
        total["bound"] += count * b_ms
        print(f"K2 {shape} x{count} ({p}): {ms:.4f} ms a call, bound {b_ms:.4f} ({by}), "
              f"{cs.k2_bytes(128, shape) / ms / 1e6:.0f} GB/s; device ms a call: "
              + ", ".join(f"{name} {v:.4f}" for name, v in split.items()), flush=True)
    print(f"per B3 forward at batch 128 (20 launches): {total['ms']:.4f} ms, bound "
          f"{total['bound']:.4f} ms", flush=True)


def plans() -> None:
    import chip_smoke as cs
    import torch

    from deepfakedetection_tpu_torch.ops import build
    from deepfakedetection_tpu_torch.ops import expand_dw as k2

    lib = build.library()
    for i, (shape, _) in enumerate(cs.K2_SHAPES):
        x, wexp, bexp, wdw, bdw = args = _inputs(shape, 200 + i, "cuda")
        H, W, Cin, Ce, k = shape
        sms = k2.sm_count(x.device)
        chosen = k2.plan(H, W, Cin, Ce, k, 128, sms)
        ry, rpool = k2.expand_dw_silu_pool_plain(*args, kernel=k)
        y, pool = torch.empty_like(ry), torch.empty_like(rpool)
        wpack = torch.empty(k2.wpack_words(Cin, Ce), dtype=torch.int32, device=x.device)
        results = []
        for CB, RB in itertools.product((64, 32), range(H, min(H, max(k // 2, 1)) - 1, -1)):
            p = k2.make_plan(128, H, W, Cin, Ce, k, CB, RB, sms)
            if p.smem_bytes > k2.MAX_SMEM_BYTES:
                continue

            def call(p=p):
                rc = lib.dfd_expand_dw_silu_pool(
                    *(t.data_ptr() for t in args), y.data_ptr(), pool.data_ptr(),
                    wpack.data_ptr(), 128, H, W, Cin, Ce, k, p.CB, p.RB,
                    torch.cuda.current_stream().cuda_stream)
                build.check(rc, "expand_dw_silu_pool")

            call()
            torch.cuda.synchronize()
            ok = True
            try:
                cs.check_close("K2 y", y, ry, *cs.K2_TOL["y"])
                cs.check_close("K2 pool", pool, rpool, *cs.K2_TOL["pool"])
            except AssertionError:
                ok = False
            results.append((statistics.median(cs.cuda_times(call, runs=10)), p, ok))
        results.sort(key=lambda r: r[0])
        print(f"K2 {shape}: plan picks CB {chosen.CB} RB {chosen.RB} (cost {chosen.cost}); "
              f"{len(results)} plans, the fastest:", flush=True)
        for ms, p, ok in results[:8]:
            print(f"  {ms:.4f} ms: CB {p.CB} RB {p.RB} steps {p.steps} grid {p.grid} "
                  f"smem {p.smem_bytes} cost {p.cost}{'' if ok else ' WRONG'}"
                  f"{' <- plan' if p == chosen else ''}", flush=True)


# K2's SiLU, as shipped (``expand_dw.cu``), and the variants ``--silu`` builds
SILU_SHIPPED = ("__device__ __forceinline__ float silu(float v) { return __fdividef(v, 1.0f + "
                "__expf(-v)); }")
SILUS = {"precise": "v / (1.0f + expf(-v))", "fast": "__fdividef(v, 1.0f + __expf(-v))",
         "fast exp": "v / (1.0f + __expf(-v))", "fast div": "__fdividef(v, 1.0f + expf(-v))"}


def _silu_library(name: str, body: str) -> ctypes.CDLL:
    """K1 and K2 built from copies of their sources with K2's SiLU replaced
    by ``body``, into build/profile_k2/silu_<name>/lib.so, with the K1 and K2
    entry points' argument types set."""
    from deepfakedetection_tpu_torch.ops import build

    out = build.BUILD_DIR.parent / "profile_k2" / f"silu_{name.replace(' ', '_')}"
    out.mkdir(parents=True, exist_ok=True)
    text = (build.CSRC / "expand_dw.cu").read_text()
    if text.count(SILU_SHIPPED) != 1:
        raise RuntimeError("expand_dw.cu changed: its SiLU line is not SILU_SHIPPED")
    (out / "expand_dw.cu").write_text(text.replace(
        SILU_SHIPPED, f"__device__ __forceinline__ float silu(float v) {{ return {body}; }}"))
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-I", str(build.CSRC), "-shared", "-o",
                    str(out / "lib.so"), str(out / "expand_dw.cu"),
                    str(build.CSRC / "depthwise_se.cu")], check=True)
    lib = ctypes.CDLL(str(out / "lib.so"))
    for fn in ("dfd_depthwise_silu_pool", "dfd_expand_dw_plan", "dfd_expand_dw_silu_pool"):
        getattr(lib, fn).argtypes = build._SIGNATURES[fn]
        getattr(lib, fn).restype = ctypes.c_int
    lib.dfd_error_string.argtypes = [ctypes.c_int]
    lib.dfd_error_string.restype = ctypes.c_char_p
    return lib


def _plain_f32(x, wexp, bexp, wdw, bdw, k):
    """The plain version's f32 activation before its last rounding (its
    expanded map rounded to bf16, as the kernel rounds it) and its pool."""
    import torch
    import torch.nn.functional as F

    Ce = wexp.shape[1]
    e = x.float() @ wexp.to(torch.bfloat16).float() + bexp
    e = F.silu(e).to(torch.bfloat16).float().permute(0, 3, 1, 2)
    wf = wdw.permute(2, 0, 1).reshape(Ce, 1, k, k)
    yf = F.silu(F.conv2d(e, wf, None, 1, k // 2, 1, Ce) + bdw.view(1, Ce, 1, 1))
    return yf.permute(0, 2, 3, 1), yf.mean(dim=(2, 3))


def silu() -> None:
    import chip_smoke as cs
    import torch

    from deepfakedetection_tpu_torch.ops import build
    from deepfakedetection_tpu_torch.ops import expand_dw as k2

    device = torch.device("cuda", 0)
    with concurrent.futures.ThreadPoolExecutor(len(SILUS)) as pool:  # the nvcc runs together
        libs = dict(zip(SILUS, pool.map(_silu_library, SILUS, SILUS.values())))
    shipped = build.library
    state = cs.seeded_b3_state()
    ys = {}
    try:
        for name, lib in libs.items():
            build.library = lambda lib=lib: lib
            total = 0.0
            for i, (shape, count) in enumerate(cs.K2_SHAPES):
                args, k = _inputs(shape, 200 + i, device), shape[-1]
                y, pool = k2.expand_dw_silu_pool(*args, kernel=k)
                tf32 = torch.backends.cudnn.allow_tf32
                torch.backends.cudnn.allow_tf32 = False  # the reference in full f32
                try:
                    yf, pf = _plain_f32(*args, k)
                finally:
                    torch.backends.cudnn.allow_tf32 = tf32
                step = 2.0 ** (torch.floor(torch.log2(yf.abs().clamp_min(
                    2.0**-8 * float(yf.abs().max())))) - 7)
                steps = float(((y.float() - yf).abs() / step).max())
                dpool = float((pool - pf).abs().max() / pf.abs().max())
                ys.setdefault(i, {})[name] = y
                differ = float((y != ys[i]["precise"]).float().mean())
                ms = statistics.median(cs.cuda_times(
                    lambda: k2.expand_dw_silu_pool(*args, kernel=k), runs=25))
                total += count * ms
                print(f"silu {name!r} K2 {shape}: y differs from the precise build's in "
                      f"{differ:.4%} of elements; max|y - y_f32| {steps:.3f} bf16 steps; "
                      f"max|dpool|/scale {dpool:.3e}; {ms:.4f} ms a call", flush=True)
            print(f"silu {name!r}: K2 per B3 forward at batch 128 {total:.4f} ms", flush=True)
            report = {"phase2": {"timings": {cs.EVAL_BATCH: {"kernels_ms": {"median": 18.0}}}}}
            cs.phase3(device, report, state)
            ref = report["phase3"]["reference"]
            print(f"silu {name!r}: phase 3's 16 images max|dlogit|/scale "
                  f"{ref['max_rel_dlogit_bf16']:.4e} against bf16 CPU, "
                  f"{ref['max_rel_dlogit_f32']:.4e} against f32 CPU", flush=True)
    finally:
        build.library = shipped


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    group = parser.add_mutually_exclusive_group()
    group.add_argument("--tree", help="compare with the K2 of the checkout in this directory")
    group.add_argument("--plans", action="store_true", help="time every plan that fits")
    group.add_argument("--silu", action="store_true", help="K2's SiLU variants, phase 3 each")
    args = parser.parse_args()
    import chip_smoke as cs
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_k2: no CUDA card")
    print(cs.smi(), flush=True)
    if args.tree:
        compare(args.tree)
    elif args.plans:
        plans()
    elif args.silu:
        silu()
    else:
        times()


if __name__ == "__main__":
    main()
