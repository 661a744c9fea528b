"""K2 (``ops/csrc/expand_dw.cu``) on one CUDA card at ``chip_smoke.K2_SHAPES``
(EfficientNet-B3's stride-1 expand blocks at batch 128). Run from the
repository root:

    python -m deepfakedetection_tpu_torch.profile_k2              # times a shape
    python -m deepfakedetection_tpu_torch.profile_k2 --tree DIR   # ... against DIR's K2
    python -m deepfakedetection_tpu_torch.profile_k2 --plans      # every plan that fits

The default times ``expand_dw_silu_pool`` as ``chip_smoke.phase1`` does (CUDA
events, median of 25) with its bound, the bytes it must move over its time,
and each of its kernels' device time (``torch.profiler``). ``--tree DIR``
builds the K2 of another checkout (say the parent commit, unpacked with
``git archive`` into a directory ``.gitignore`` lists) from its
``expand_dw.cu`` alone, runs the same operands through both entry points at
every shape (outputs bit-identical or not, each against the plain version
within ``chip_smoke.K2_TOL``) and times them in turns (other, this, this,
other). ``--plans`` times every launch plan (CB, RB) that fits at each
shape through the entry point, which takes the plan from its caller, each
checked against the plain version, beside the one ``plan`` picks.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import itertools
import statistics
import subprocess
import sys
from pathlib import Path


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
    (median of 13 calls in each of the turns other, this, this, other)."""
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
        for name in ("other", "this", "this", "other"):
            ms[name] += cs.cuda_times(runs[name], runs=13)
        row = {"shape": shape, "bit_identical": all(torch.equal(a, b) for a, b in
                                                     zip(outs["other"], outs["this"])),
               **{f"{name}_ms": statistics.median(t) for name, t in ms.items()}}
        rows.append(row)
        print(f"K2 {shape}: within K2_TOL both; bit-identical to {tree}'s {row['bit_identical']}; "
              f"ms a call: this {row['this_ms']:.4f}, {tree}'s {row['other_ms']:.4f}", flush=True)
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
        split = cs.kernel_split(lambda: k2.expand_dw_silu_pool(*args, kernel=k))[0]
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


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    group = parser.add_mutually_exclusive_group()
    group.add_argument("--tree", help="compare with the K2 of the checkout in this directory")
    group.add_argument("--plans", action="store_true", help="time every plan that fits")
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
    else:
        times()


if __name__ == "__main__":
    main()
