"""K7 (``ops/csrc/attn4d.cu``, talking-head attention) against another
checkout's, on one CUDA card, at ``chip_smoke.K7_SHAPES`` (EfficientFormerV2-S1's
shape at batch 256) and ``chip_smoke.K7_ODD``. Run from the repository root:

    python -m deepfakedetection_tpu_torch.profile_k7 --tree DIR [--tree DIR ...]

It builds the K7 of another checkout (say the parent commit, unpacked with
``git archive`` into a directory ``.gitignore`` lists) from its ``attn4d.cu``
and the headers it includes, and from nothing else, runs the same operands
through both entry points at every shape (this checkout's held to the plain
version within two bf16 steps of the output's scale; the other's distance
from it reported, and whether the two outputs are bit-identical) and times
both at ``K7_SHAPES`` in turns (other, this, this, other), by CUDA events and
by the device time of their kernels. ``chip_smoke.py --parent DIR`` runs this
comparison in its phase 1 and requires bit-identical outputs.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import subprocess
from pathlib import Path

KERNELS = ("attn4d_kernel",)  # the device kernel of both designs, as the profiler names it


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
        from deepfakedetection_tpu_torch.ops import build

        if self.fn is None:
            digest = hashlib.sha256(" ".join(build.NVCC_FLAGS).encode())
            for src in sorted(self.csrc.glob("*.cu*")):
                digest.update(src.read_bytes())
            out = build.BUILD_DIR.parent / "profile_k7" / f"k7_{digest.hexdigest()[:16]}.so"
            if not out.exists():
                out.parent.mkdir(parents=True, exist_ok=True)
                subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(out),
                                str(self.csrc / "attn4d.cu")], check=True)
            lib = ctypes.CDLL(str(out))
            self.planned = hasattr(lib, "dfd_attn4d_plan")
            P, I, F, L = ctypes.c_void_p, ctypes.c_int, ctypes.c_float, ctypes.c_longlong
            self.fn = lib.dfd_attn4d
            self.fn.argtypes = ([P] * 9 + [I] * 5 + [L] * 6 + ([I] if self.planned else [])
                                + [F, I, P])
            self.fn.restype = ctypes.c_int
        return self.fn

    def __call__(self, q, k, v, bias, th1, th1_b, th2, th2_b, *, num_heads: int, scale: float):
        import torch

        from deepfakedetection_tpu_torch.ops.expand_dw import sm_count

        fn = self._entry()
        B, N, Cq = q.shape
        d, dv = Cq // num_heads, v.shape[2] // num_heads
        out = torch.empty(B, N, num_heads * dv, dtype=torch.bfloat16, device=q.device)
        strides = (q.stride(0), q.stride(1), k.stride(0), k.stride(1), v.stride(0), v.stride(1))
        vec = int(all(s % 8 == 0 for s in strides)
                  and all(t.data_ptr() % 16 == 0 for t in (q, k, v)))
        sms = [sm_count(q.device)] if self.planned else []
        rc = fn(*(t.data_ptr() for t in (q, k, v, bias, th1, th1_b, th2, th2_b)),
                out.data_ptr(), B, N, num_heads, d, dv, *strides, *sms, float(scale), vec,
                torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"the other tree's dfd_attn4d failed: CUDA error {rc}")
        return out


def compare(tree: str, shapes=None, odd=None) -> list[dict]:
    """This checkout's K7 against ``tree``'s: at ``shapes`` (default
    ``chip_smoke.K7_SHAPES``) and ``odd`` (``chip_smoke.K7_ODD``) this one
    within two bf16 steps of the plain version's output scale (raises
    otherwise), the other's largest distance from the plain version in bf16
    steps of that scale, and whether the two outputs are bit-identical; at
    ``shapes`` both timed in turns (``profile_k3.turns``)."""
    import chip_smoke as cs
    import torch

    from deepfakedetection_tpu_torch.ops import attn4d as k7
    from deepfakedetection_tpu_torch.profile_k3 import turns

    other, rows = Other(tree), []
    cases = [(s[:5], True) for s in (shapes or cs.K7_SHAPES)]
    cases += [(s, False) for s in (cs.K7_ODD if odd is None else odd)]
    for i, ((B, N, h, d, dv), timed) in enumerate(cases):
        args = cs.k7_inputs(B, N, h, d, dv, seed=800 + i, device="cuda")
        kw = {"num_heads": h, "scale": d**-0.5}
        runs = {"other": lambda: other(*args, **kw), "this": lambda: k7.attn4d(*args, **kw)}
        ref = k7.attn4d_plain(*args, **kw)
        step = cs.two_steps(ref) / 2
        outs = {name: fn() for name, fn in runs.items()}
        torch.cuda.synchronize()
        cs.check_close(f"this K7 {(B, N, h, d, dv)}", outs["this"], ref, 2 * step, 0.0)
        off = float((outs["other"].float() - ref.float()).abs().max())
        row = {"shape": (B, N, h, d, dv),
               "bit_identical": torch.equal(outs["other"], outs["this"]),
               "other_steps_from_plain": off / max(step, 1e-30)}
        if timed:
            row.update(turns(runs, dict.fromkeys(runs, KERNELS)))
        rows.append(row)
        text = (f"K7 {(B, N, h, d, dv)}: this within two bf16 steps; bit-identical to {tree}'s "
                f"{row['bit_identical']} (the other {row['other_steps_from_plain']:g} steps from "
                "the plain version)")
        if timed:
            text += (f"; ms a call: this {row['this_ms']:.4f} (device "
                     f"{row['this_device_ms']:.4f}), {tree}'s {row['other_ms']:.4f} (device "
                     f"{row['other_device_ms']:.4f}); device ratio "
                     f"{row['this_device_ms'] / row['other_device_ms']:.3f}")
        print(text, flush=True)
    return rows


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", required=True, action="append",
                        help="compare with the K7 of the checkout in this directory (repeatable)")
    args = parser.parse_args()
    import chip_smoke as cs
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_k7: no CUDA card")
    print(cs.smi(), flush=True)
    for tree in args.tree:
        compare(tree)


if __name__ == "__main__":
    main()
