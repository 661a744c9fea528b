"""K5 (``ops/csrc/window_attn.cu`` forward, ``window_attn_bwd.cu``
backward) against another checkout's, on one CUDA card: the backward at
``chip_smoke.K5_BWD_SHAPES`` (FasterViT-2's fine-tune step at batch 128),
with ``--fwd`` the forward at ``chip_smoke.K5_SHAPES`` (its eval forward at
batch 256), both head configurations. Run from the repository root:

    python -m deepfakedetection_tpu_torch.profile_k5 --tree DIR [--fwd]

``--tree DIR`` builds the K5 backward (or forward) of another checkout (say
the parent commit, unpacked with ``git archive`` into a directory
``.gitignore`` lists) from its ``window_attn_bwd.cu`` (``window_attn.cu``)
alone, runs the same operands through both entry points at every shape (each
held to the plain version with phase 1's tolerances; outputs bit-identical
or not) and times them in turns (other, this, this, other), by CUDA events
and by the device time of their kernels. ``chip_smoke.py --parent DIR`` runs
both comparisons in its phase 1.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import statistics
import subprocess
import sys
from pathlib import Path


def _inputs(shape, seed: int, device):
    """(qkv, bias, dout, heads, scale) at a K5_BWD_SHAPES row, as phase 1 makes them."""
    import torch

    _, B, N, C, h, _ = shape
    g = torch.Generator().manual_seed(seed)
    qkv = torch.randn(B, N, 3 * C, generator=g).to(torch.bfloat16).to(device)
    bias = torch.randn(h, N, N, generator=g).to(device)
    dout = torch.randn(B, N, C, generator=g).to(torch.bfloat16).to(device)
    return qkv, bias, dout, h, (C // h) ** -0.5


def check(name: str, dqkv, dbias, qkv, bias, dout, h: int, scale: float) -> None:
    """dq, dk and dv within two bf16 steps of the plain version's, dbias
    within ``chip_smoke.K5_BWD_DBIAS_TOL`` of its scale."""
    import chip_smoke as cs

    from deepfakedetection_tpu_torch.ops import window_attn as k5

    ref_qkv, ref_bias = k5.window_attention_bwd_plain(qkv, bias, dout, num_heads=h, scale=scale)
    C = qkv.shape[-1] // 3
    for i, part in enumerate(("dq", "dk", "dv")):
        ref = ref_qkv[..., i * C:(i + 1) * C]
        cs.check_close(f"{name} {part}", dqkv[..., i * C:(i + 1) * C], ref, cs.two_steps(ref), 0.0)
    cs.check_close(f"{name} dbias", dbias, ref_bias,
                   cs.K5_BWD_DBIAS_TOL * float(ref_bias.abs().max()), 0.0)


class Other:
    """K5 of the checkout in ``tree``: its ``window_attn.cu`` (forward) or
    ``window_attn_bwd.cu`` (backward), each built alone into
    ``build/profile_k5/`` at first use and called through its C entry point,
    in the convention of its ``ops/window_attn.py``: the forward with or
    without a plan (``fwd_plan``, since the persistent design), the backward
    with a window group a block (``bwd_windows_per_block``, the design before
    persistent blocks) or a plan (``bwd_plan``)."""

    def __init__(self, tree: str):
        ops = Path(tree) / "deepfakedetection_tpu_torch" / "ops"
        self.csrc = ops / "csrc"
        spec = importlib.util.spec_from_file_location("other_window_attn", ops / "window_attn.py")
        self.mod = importlib.util.module_from_spec(spec)
        sys.modules[spec.name] = self.mod
        spec.loader.exec_module(self.mod)
        self.planned_fwd = hasattr(self.mod, "fwd_plan")
        self.grouped = hasattr(self.mod, "bwd_windows_per_block")
        self.libs = {}

    def _entry(self, source: str, name: str, argtypes):
        """The C entry ``name`` of ``source`` built alone (cached by the
        sources' and flags' hash)."""
        from deepfakedetection_tpu_torch.ops import build

        if source not in self.libs:
            digest = hashlib.sha256(" ".join(build.NVCC_FLAGS).encode())
            for src in sorted(self.csrc.glob("*.cu*")):
                digest.update(src.read_bytes())
            out = (build.BUILD_DIR.parent / "profile_k5"
                   / f"{Path(source).stem}_{digest.hexdigest()[:16]}.so")
            if not out.exists():
                out.parent.mkdir(parents=True, exist_ok=True)
                subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(out),
                                str(self.csrc / source)], check=True)
            self.libs[source] = ctypes.CDLL(str(out))
        fn = getattr(self.libs[source], name)
        fn.argtypes, fn.restype = argtypes, ctypes.c_int
        return fn

    def fwd(self, qkv, bias, h: int, scale: float):
        import torch

        from deepfakedetection_tpu_torch.ops import build

        B, N, C3 = qkv.shape
        C, dev = C3 // 3, qkv.device
        d = C // h
        P, I, F, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        fn = self._entry("window_attn.cu", "dfd_window_attention",
                         build._SIGNATURES["dfd_window_attention"] if self.planned_fwd
                         else [P] * 5 + [I] * 4 + [L] * 12 + [F, I, P])
        out = torch.empty(B, N, C, dtype=torch.bfloat16, device=dev)
        src = (qkv.stride(0), qkv.stride(1), d)
        vec = int(d % 8 == 0 and all(s % 8 == 0 for s in src[:2]))
        sms = [torch.cuda.get_device_properties(dev).multi_processor_count] \
            if self.planned_fwd else []
        rc = fn(qkv.data_ptr(), qkv[..., C:].data_ptr(), qkv[..., 2 * C:].data_ptr(),
                bias.data_ptr(), out.data_ptr(), B, N, h, d, *src, *src, *src, N * C, C, d, *sms,
                scale, vec, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"the other tree's dfd_window_attention failed: CUDA error {rc}")
        return out

    def bwd(self, qkv, bias, dout, h: int, scale: float):
        import torch

        from deepfakedetection_tpu_torch.ops import build

        B, N, C3 = qkv.shape
        C, dev = C3 // 3, qkv.device
        d = C // h
        P, I, F, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
        fn = self._entry("window_attn_bwd.cu", "dfd_window_attention_bwd",
                         [P] * 6 + [I] * 4 + [L] * 4 + [I, F, I, P] if self.grouped
                         else build._SIGNATURES["dfd_window_attention_bwd"])
        dqkv = torch.empty(B, N, C3, dtype=torch.bfloat16, device=dev)
        dbias = torch.empty(h, N, N, dtype=torch.float32, device=dev)
        strides = (qkv.stride(0), qkv.stride(1), dout.stride(0), dout.stride(1))
        vec = int(d % 8 == 0 and all(s % 8 == 0 for s in strides))
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = (qkv.data_ptr(), dout.data_ptr(), bias.data_ptr(), dqkv.data_ptr())
        if self.grouped:
            per_block = self.mod.bwd_windows_per_block(B, h)
            partial = torch.empty(-(-B // per_block), h, N, N, dtype=torch.float32, device=dev)
            rc = fn(*ptrs, partial.data_ptr(), dbias.data_ptr(), B, N, h, d, *strides, per_block,
                    scale, vec, stream)
        else:
            sms = torch.cuda.get_device_properties(dev).multi_processor_count
            plan = self.mod.bwd_plan(B, N, h, d, sms)
            partial = torch.empty(plan.blocks(h), N, N, dtype=torch.float32, device=dev)
            rc = fn(*ptrs, partial.data_ptr(), partial.shape[0], dbias.data_ptr(), B, N, h, d,
                    *strides, sms, scale, vec, stream)
        if rc:
            raise RuntimeError(f"the other tree's dfd_window_attention_bwd failed: CUDA error {rc}")
        return dqkv, dbias


def _turns(runs: dict, expect) -> dict:
    """Each of ``runs``' time a call (median of 13 calls in each of the turns
    other, this, this, other) and device time a call (``kernel_split`` over
    10 calls in each of the same turns, the mean)."""
    import chip_smoke as cs

    ms = {name: [] for name in runs}
    dev = {name: [] for name in runs}
    for name in ("other", "this", "this", "other"):
        ms[name] += cs.cuda_times(runs[name], runs=13)
        dev[name].append(sum(cs.kernel_split(runs[name], expect=expect)[0].values()))
    return {**{f"{name}_ms": statistics.median(t) for name, t in ms.items()},
            **{f"{name}_device_ms": statistics.mean(t) for name, t in dev.items()}}


def compare(tree: str, shapes=None) -> list[dict]:
    """This checkout's K5 backward against ``tree``'s at ``shapes`` (default
    ``chip_smoke.K5_BWD_SHAPES``): both held to the plain version, whether
    their dqkv are bit-identical, and both timed in turns (``_turns``; both
    launch the kernels ``window_attn.BWD_KERNELS`` names)."""
    import chip_smoke as cs
    import torch

    from deepfakedetection_tpu_torch.ops import window_attn as k5

    other, rows = Other(tree), []
    for i, shape in enumerate(shapes or cs.K5_BWD_SHAPES):
        qkv, bias, dout, h, scale = _inputs(shape, 500 + i, "cuda")
        runs = {"other": lambda: other.bwd(qkv, bias, dout, h, scale),
                "this": lambda: k5.window_attention_bwd(qkv, bias, dout, num_heads=h,
                                                        scale=scale)}
        outs = {}
        for name, fn in runs.items():
            outs[name] = fn()
            torch.cuda.synchronize()
            check(f"{name} K5 backward {shape[:5]}", *outs[name], qkv, bias, dout, h, scale)
        row = {"shape": shape[:5],
               "bit_identical_dqkv": torch.equal(outs["other"][0], outs["this"][0]),
               **_turns(runs, k5.BWD_KERNELS)}
        rows.append(row)
        print(f"K5 backward {shape[:5]}: within the tolerances both; dqkv bit-identical to "
              f"{tree}'s {row['bit_identical_dqkv']}; ms a call: this {row['this_ms']:.4f} "
              f"(device {row['this_device_ms']:.4f}), {tree}'s {row['other_ms']:.4f} (device "
              f"{row['other_device_ms']:.4f})", flush=True)
    return rows


def compare_fwd(tree: str, shapes=None) -> list[dict]:
    """This checkout's K5 forward against ``tree``'s at ``shapes`` (default
    ``chip_smoke.K5_SHAPES``, phase 1's inputs): both within two bf16 steps
    of the plain version, whether their outputs are bit-identical (and by
    how many bf16 steps of the output's scale they differ), and both timed in
    turns (``_turns``; both launch ``window_attn.FWD_KERNELS``)."""
    import chip_smoke as cs
    import torch

    from deepfakedetection_tpu_torch.ops import window_attn as k5

    other, rows = Other(tree), []
    for i, shape in enumerate(shapes or cs.K5_SHAPES):
        qkv, bias, h, scale = cs.k5_inputs(shape, 400 + i, "cuda")
        runs = {"other": lambda: other.fwd(qkv, bias, h, scale),
                "this": lambda: k5.window_attention(qkv, bias, num_heads=h, scale=scale)}
        ref = k5.window_attention_plain(qkv, bias, num_heads=h, scale=scale)
        outs = {}
        for name, fn in runs.items():
            outs[name] = fn()
            torch.cuda.synchronize()
            cs.check_close(f"{name} K5 forward {shape[:5]}", outs[name], ref, cs.two_steps(ref),
                           0.0)
        diff = float((outs["other"].float() - outs["this"].float()).abs().max())
        row = {"shape": shape[:5], "bit_identical": torch.equal(outs["other"], outs["this"]),
               "max_diff_bf16_steps": diff / (cs.two_steps(ref) / 2),
               **_turns(runs, k5.FWD_KERNELS)}
        rows.append(row)
        print(f"K5 forward {shape[:5]}: within two bf16 steps both; bit-identical to {tree}'s "
              f"{row['bit_identical']} ({row['max_diff_bf16_steps']:g} steps apart); ms a call: "
              f"this {row['this_ms']:.4f} (device {row['this_device_ms']:.4f}), {tree}'s "
              f"{row['other_ms']:.4f} (device {row['other_device_ms']:.4f})", flush=True)
    return rows


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", required=True,
                        help="compare with the K5 of the checkout in this directory")
    parser.add_argument("--fwd", action="store_true",
                        help="compare the forward (at chip_smoke.K5_SHAPES), not the backward")
    args = parser.parse_args()
    import chip_smoke as cs
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_k5: no CUDA card")
    print(cs.smi(), flush=True)
    (compare_fwd if args.fwd else compare)(args.tree)


if __name__ == "__main__":
    main()
