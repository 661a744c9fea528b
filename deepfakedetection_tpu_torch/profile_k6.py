"""Where the time of K6's forward (``ops/csrc/attn_block.cu``) goes, on one
CUDA card, at ``chip_smoke.K6_SHAPES`` (FasterViT-2 at batch 256, both head
configurations). Run from the repository root:

    python -m deepfakedetection_tpu_torch.profile_k6              # times a shape
    python -m deepfakedetection_tpu_torch.profile_k6 --tree DIR   # ... of DIR's K6
    python -m deepfakedetection_tpu_torch.profile_k6 --phases     # per-phase clocks
    python -m deepfakedetection_tpu_torch.profile_k6 --plans      # every plan that fits
    python -m deepfakedetection_tpu_torch.profile_k6 --bwd [--tree DIR]  # the backward's split

The default times ``attn_subblock`` as ``chip_smoke.phase1_k6`` does (f32
weights, CUDA events, median of 25) and each of its two kernels' device time
(``torch.profiler``). ``--tree DIR`` first holds this checkout's forward to
the package of another (say the parent commit, unpacked with ``git archive``
into a directory ``.gitignore`` lists): both libraries built, the same
operands through each entry point at every shape, bit-identical or not, and
their times in turns (other, this, this, other); then it times DIR's K6 as
the default does, so two versions compare within one call.
``--phases`` builds a copy of the source with ``clock64`` counters in the
first kernel and prints, per block, the microseconds (at 1.755 GHz) its
consumer warps 0 and 4 spend staging x, waiting for weight tiles, issuing and
retiring products, in the epilogue, attending and waiting at barriers.
``--plans`` builds a copy whose entry point takes a plan from the caller and
times every plan that fits at each shape (the search behind ``fwd_plan``'s
order), checking each against the plain version. ``--bwd`` times
``attn_subblock_bwd`` at ``chip_smoke.K6_BWD_SHAPES`` (FasterViT-2's fine-tune
step at batch 128) and gives each of its kernels' device time a call and the
kernels it launches a call; with ``--tree DIR`` it does so for DIR's K6.
"""

from __future__ import annotations

import argparse
import ctypes
import itertools
import os
import re
import statistics
import subprocess
import sys
from pathlib import Path

CLOCK_GHZ = 1.755  # the H100 SXM's boost clock, to turn clock64 counts into time
PHASES = ("stage x", "weight waits", "products", "epilogue", "barrier after products",
          "attention", "barrier after attention", "consumer total", "with cluster exit")


def _edit(text: str, edits: list[tuple[str, str]]) -> str:
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"attn_block.cu changed: anchor not found once: {old[:60]!r}")
        text = text.replace(old, new)
    return text


# clock64 counters in attn_qkv_kernel: per block, warps 0 and 4 add their
# phase times to g_phase (dfd_phase_read returns and clears them)
PHASE_EDITS = [
    ("\nnamespace {\n\n", "\n__device__ unsigned long long g_phase[16];\nnamespace {\n\n"),
    ("  extern __shared__ unsigned char smem_raw[];\n"
     "  unsigned char* ring = aligned_smem(smem_raw);\n  const int d = C / heads",
     "  extern __shared__ unsigned char smem_raw[];\n  long long t_start = clock64(), tq = 0, "
     "ta[9] = {};\n  unsigned char* ring = aligned_smem(smem_raw);\n  const int d = C / heads"),
    ("    named_sync(1, kConsumers);\n\n",
     "    named_sync(1, kConsumers);\n    ta[0] = clock64() - t_start;\n\n"),
    ("          mbar_wait(&full[s], phase);\n          if (live) {",
     "          tq = clock64();\n          mbar_wait(&full[s], phase);\n"
     "          ta[1] += clock64() - tq;\n          tq = clock64();\n          if (live) {"),
    ("            release(s);\n          }\n",
     "            release(s);\n          }\n          ta[2] += clock64() - tq;\n"),
    ("        if (!live) continue;\n        wgmma_wait<0>();",
     "        if (!live) continue;\n        tq = clock64();\n        wgmma_wait<0>();"),
    ("        }\n      }\n      cp_async_wait<0>();\n      named_sync(1, kConsumers);",
     "        }\n        ta[3] += clock64() - tq;\n      }\n      tq = clock64();\n"
     "      cp_async_wait<0>();\n      named_sync(1, kConsumers);\n      ta[4] += clock64() - tq;\n"
     "      tq = clock64();"),
    ("      named_sync(1, kConsumers);  // the group's q, k, v and biases are free",
     "      ta[5] += clock64() - tq;\n      tq = clock64();\n      named_sync(1, kConsumers);\n"
     "      ta[6] += clock64() - tq;"),
    ("  cluster_sync();  // no block leaves while its peer may still write to it\n}",
     "  ta[7] = clock64() - t_start;\n  cluster_sync();\n  ta[8] = clock64() - t_start;\n"
     "  if (threadIdx.x == 0 || threadIdx.x == 128)\n    for (int i = 0; i < 9; ++i) "
     "atomicAdd(&g_phase[i], static_cast<unsigned long long>(ta[i]));\n"
     "  if (threadIdx.x == 0) atomicAdd(&g_phase[15], 1ull);\n}"),
]
PHASE_READ = """
extern "C" int dfd_phase_read(unsigned long long* out) {
  cudaMemcpyFromSymbol(out, g_phase, sizeof(g_phase));
  unsigned long long zero[16] = {};
  return cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));
}
"""
# the entry point takes the plan set by dfd_set_plan (all zero: its own)
PLAN_EDITS = [
    ("\nnamespace {\n\n",
     "\nstatic int g_plan[8];\nextern \"C\" void dfd_set_plan(const int* p) {\n"
     "  for (int i = 0; i < 8; ++i) g_plan[i] = p[i];\n}\nnamespace {\n\n"),
    ("  const FwdPlan p = {plan[0], plan[1], plan[2], plan[3], plan[4], plan[5], plan[6]};",
     "  const int* q = g_plan[0] ? g_plan : plan;\n"
     "  const FwdPlan p = {q[0], q[1], q[2], q[3], q[4], q[5], q[6]};"),
]


def _build_copy(name: str, edits: list[tuple[str, str]], extra: str = "") -> ctypes.CDLL:
    """nvcc of an edited copy of attn_block.cu (with the headers beside it)
    into build/profile_k6/<name>/lib.so."""
    from deepfakedetection_tpu_torch.ops import build

    out = build.BUILD_DIR.parent / "profile_k6" / name
    out.mkdir(parents=True, exist_ok=True)
    for header in build.CSRC.glob("*.cuh"):
        (out / header.name).write_text(header.read_text())
    (out / "attn_block.cu").write_text(_edit((build.CSRC / "attn_block.cu").read_text(), edits)
                                       + extra)
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(out / "lib.so"),
                    str(out / "attn_block.cu")], check=True)
    lib = ctypes.CDLL(str(out / "lib.so"))
    lib.dfd_attn_subblock.argtypes = build._SIGNATURES["dfd_attn_subblock"]
    return lib


class Call:
    """One K6 forward at a shape, through a given library's entry point."""

    def __init__(self, shape, seed, device):
        import chip_smoke as cs
        import torch

        from deepfakedetection_tpu_torch.ops import attn_block as k6

        _, B, N, C, h, _ = shape
        x, wq, bq, bias, wp, bp, _ = cs.k6_inputs(B, N, C, h, seed, device)
        self.args, self.shape, d = [x, wq, bq, bias, wp, bp], (B, N, C, h), C // h
        self.scale = d**-0.5
        self.wq, self.bq = k6._qkv_operands(wq, bq, h, d, C)
        self.wp, self.bp = k6._proj_operand(wp, C), bp.float().contiguous()
        self.out = torch.empty(B, N, C, dtype=torch.bfloat16, device=device)
        self.ctx = torch.empty(B * N, k6._pad16(C), dtype=torch.bfloat16, device=device)

    def __call__(self, lib) -> None:
        import torch

        B, N, C, h = self.shape
        x, _, _, bias, _, _ = self.args
        rc = lib.dfd_attn_subblock(x.data_ptr(), self.wq.data_ptr(), self.bq.data_ptr(),
                                   bias.data_ptr(), self.wp.data_ptr(), self.bp.data_ptr(),
                                   self.out.data_ptr(), self.ctx.data_ptr(), B, N, C, h,
                                   self.scale, int(C % 8 == 0),
                                   torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"dfd_attn_subblock failed: CUDA error {rc}")


def compare_forward(tree: str) -> None:
    """This checkout's K6 forward against the one in ``tree``: outputs
    bit-identical or not, and the two times in turns, at every shape."""
    import importlib.util

    import chip_smoke as cs
    import torch

    from deepfakedetection_tpu_torch.ops import build

    spec = importlib.util.spec_from_file_location(
        "other_build", Path(tree) / "deepfakedetection_tpu_torch" / "ops" / "build.py")
    other = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(other)
    libs = {"other": other.library(), "this": build.library()}
    totals = {"other": 0.0, "this": 0.0}
    for i, shape in enumerate(cs.K6_SHAPES):
        call = Call(shape, 800 + i, torch.device("cuda"))
        outs = {}
        for name, lib in libs.items():
            call(lib)
            torch.cuda.synchronize()
            outs[name] = call.out.clone()
        ms = {name: [] for name in libs}
        for name in ("other", "this", "this", "other"):
            ms[name] += cs.cuda_times(lambda: call(libs[name]), runs=13)
        med = {name: statistics.median(t) for name, t in ms.items()}
        for name in libs:
            totals[name] += shape[5] * med[name]
        print(f"forward {shape[0]} {call.shape}: bit-identical to {tree}'s "
              f"{torch.equal(outs['other'], outs['this'])}; ms a call: this {med['this']:.4f}, "
              f"{tree}'s {med['other']:.4f}", flush=True)
    for name, total in totals.items():
        print(f"forward per FasterViT-2 forward at batch 256, both configurations summed, "
              f"{name}: {total:.4f} ms", flush=True)


def times() -> None:
    import chip_smoke as cs
    import torch
    from torch.profiler import ProfilerActivity, profile

    from deepfakedetection_tpu_torch.ops import attn_block as k6

    device, per = torch.device("cuda"), {}
    for i, (config, B, N, C, h, count) in enumerate(cs.K6_SHAPES):
        x, wq, bq, bias, wp, bp, _ = cs.k6_inputs(B, N, C, h, 800 + i, device)
        args, scale = [x, wq, bq, bias, wp, bp], (C // h) ** -0.5
        ms = statistics.median(cs.cuda_times(
            lambda: k6.attn_subblock(*args, num_heads=h, scale=scale), runs=25))
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(10):
                k6.attn_subblock(*args, num_heads=h, scale=scale)
            torch.cuda.synchronize()
        kernels = {(re.findall(r"\w+_kernel", e.key) or [e.key])[0]: e.device_time_total / 1e4
                   for e in prof.key_averages() if e.device_time_total > 0}
        per[config] = per.get(config, 0.0) + count * ms
        print(f"{config} windows {B} N {N} C {C} heads {h}: {ms:.4f} ms a call; device ms a "
              f"call: " + ", ".join(f"{k} {v:.4f}" for k, v in kernels.items()), flush=True)
    for config, total in per.items():
        print(f"per FasterViT-2 {config} forward at batch 256 (21 launches): {total:.4f} ms")


def bwd_times() -> None:
    import chip_smoke as cs

    from deepfakedetection_tpu_torch.ops import attn_block as k6

    per = {}
    for i, (config, B, N, C, h, count) in enumerate(cs.K6_BWD_SHAPES):
        x, wq, bq, bias, wp, _, dout = cs.k6_inputs(B, N, C, h, 900 + i, "cuda")
        scale = (C // h) ** -0.5

        def call():
            return k6.attn_subblock_bwd(x, wq, bq, bias, wp, dout, num_heads=h, scale=scale)

        ms = statistics.median(cs.cuda_times(call, runs=25))
        split, launched = cs.kernel_split(call, expect=cs.K6_BWD_KERNELS)
        agg = per.setdefault(config, {"ms": 0.0, "device": {}})
        agg["ms"] += count * ms
        for k, v in split.items():
            agg["device"][k] = agg["device"].get(k, 0.0) + count * v
        print(f"{config} windows {B} N {N} C {C} heads {h}: {ms:.4f} ms a call, "
              f"{launched:g} kernels a call; device ms a call: "
              + ", ".join(f"{k} {v:.4f}" for k, v in split.items()), flush=True)
    for config, agg in per.items():
        print(f"per FasterViT-2 {config} fine-tune step at batch 128 (21 launches): "
              f"{agg['ms']:.4f} ms; device ms: "
              + ", ".join(f"{k} {v:.4f}" for k, v in agg["device"].items()), flush=True)


def phases() -> None:
    import chip_smoke as cs
    import torch

    from deepfakedetection_tpu_torch.ops import attn_block as k6

    lib = _build_copy("phases", PHASE_EDITS, PHASE_READ)
    lib.dfd_phase_read.argtypes = [ctypes.c_void_p]
    device, counts = torch.device("cuda"), (ctypes.c_ulonglong * 16)()
    for i, shape in enumerate(cs.K6_SHAPES):
        call = Call(shape, 800 + i, device)
        ms = statistics.median(cs.cuda_times(lambda: call(lib), runs=10))
        lib.dfd_phase_read(counts)
        call(lib)
        torch.cuda.synchronize()
        lib.dfd_phase_read(counts)
        scale = 2 * counts[15] * CLOCK_GHZ * 1e3  # two warps a block, cycles to us
        print(f"{shape[0]} {call.shape} {k6.fwd_plan(*call.shape)}: {ms:.4f} ms a call; us a "
              "block: " + ", ".join(f"{p} {counts[j] / scale:.1f}" for j, p in enumerate(PHASES)),
              flush=True)


def plans() -> None:
    import chip_smoke as cs
    import torch

    from deepfakedetection_tpu_torch.ops import attn_block as k6

    lib = _build_copy("plans", PLAN_EDITS)
    lib.dfd_set_plan.argtypes = [ctypes.c_void_p]
    device, pad = torch.device("cuda"), k6._pad16
    for i, shape in enumerate(cs.K6_SHAPES):
        call = Call(shape, 800 + i, device)
        B, N, C, h = call.shape
        Cp, Dp, kt = pad(C), pad(C // h), pad(N) // 16
        ref = k6.attn_subblock_plain(*call.args, num_heads=h, scale=call.scale)
        tol, results = cs.two_steps(ref), []
        for G, HG in itertools.product(range(1, 128 // N + 1), range(1, min(h, 4) + 1)):
            if G * HG * kt > 32:
                continue
            for staged, NT, KB in itertools.product((1, 0), k6._UNITS, (1, 2)):
                if (3 * HG * Dp) % NT and NT != 32:
                    continue
                fit = [(s, k6.fwd_smem_bytes(N, Cp, Dp, G, HG, NT, KB, s, staged))
                       for s in range(8, 2, -1)]
                fit = [f for f in fit if f[1] <= k6.MAX_SMEM_BYTES]
                if not fit:
                    continue
                plan = (G, HG, NT, KB, fit[0][0], staged, fit[0][1], 0)
                lib.dfd_set_plan((ctypes.c_int * 8)(*plan))
                call(lib)
                torch.cuda.synchronize()
                ok = float((call.out.float() - ref.float()).abs().max()) <= tol
                results.append((statistics.median(cs.cuda_times(lambda: call(lib), runs=10)),
                                plan, ok))
        lib.dfd_set_plan((ctypes.c_int * 8)())
        results.sort()
        print(f"{shape[0]} {call.shape}: fwd_plan {k6.fwd_plan(B, N, C, h)}; {len(results)} "
              "plans, the fastest:", flush=True)
        for ms, (G, HG, NT, KB, stages, staged, smem, _), ok in results[:6]:
            print(f"  {ms:.4f} ms: G {G} HG {HG} NT {NT} KB {KB} stages {stages} staged "
                  f"{staged} smem {smem}{'' if ok else ' WRONG'}", flush=True)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    group = parser.add_mutually_exclusive_group()
    group.add_argument("--tree", help="time the K6 of the checkout in this directory")
    group.add_argument("--phases", action="store_true", help="per-phase clocks of kernel 1")
    group.add_argument("--plans", action="store_true", help="time every plan that fits")
    parser.add_argument("--bwd", action="store_true",
                        help="the backward's time and per-kernel split (with --tree too)")
    args = parser.parse_args()
    import chip_smoke as cs
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_k6: no CUDA card")
    print(cs.smi(), flush=True)
    if args.tree and not args.bwd:
        compare_forward(args.tree)
    if args.tree:
        # this module stays; the package it times is the other checkout's
        root = str(Path(args.tree).resolve())
        for name in [m for m in sys.modules if m.split(".")[0] == "deepfakedetection_tpu_torch"]:
            del sys.modules[name]
        sys.path.insert(0, root)
        from deepfakedetection_tpu_torch.ops import build

        if not os.path.abspath(build.__file__).startswith(root):
            raise SystemExit(f"profile_k6: {build.__file__} is not under {root}")
        print(f"K6 of {root}", flush=True)
    if args.bwd and (args.phases or args.plans):
        raise SystemExit("profile_k6: --bwd goes with --tree only")
    (bwd_times if args.bwd else phases if args.phases else plans if args.plans else times)()


if __name__ == "__main__":
    main()
