"""K3 (``ops/csrc/fused_mbconv.cu``, the whole MBConv+SE block) against
another checkout's, on one CUDA card, at ``chip_smoke.K3_SHAPES`` (B3's six
K3 shapes at batch 128) and ``chip_smoke.K3_ODD`` (batch 8). Run from the
repository root:

    python -m deepfakedetection_tpu_torch.profile_k3 --tree DIR

It builds the K3 of another checkout (say the parent commit, unpacked with
``git archive`` into a directory ``.gitignore`` lists) from its
``fused_mbconv.cu`` and ``expand_dw.cu`` and the headers they include, and
from nothing else, runs the same operands through both entry points at every
shape (each held to the plain version within two bf16 steps of the output's
scale; outputs bit-identical or not) and times them at the six B3 shapes in
turns (other, this, this, other), by CUDA events and by the device time of
their kernels, with each kernel's share. This checkout's K3 runs on weights
packed once, as ``MBConv`` runs it; so does the other tree's where its design
packs them once, else it packs them every call, as that design did.
``chip_smoke.py --parent DIR`` runs this comparison in its phase 1.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import statistics
import subprocess
from pathlib import Path

# the device kernels of the design before weights were packed once (K2's two,
# two SE products, w_proj's packing, the gated projection), by the names the
# profiler records
PARENT_KERNELS = ("pack_wexp_kernel", "expand_dw_kernel", "se_reduce_kernel",
                  "se_expand_kernel", "pack_pairs_kernel", "gated_proj_kernel")


class Other:
    """K3 of the checkout in ``tree``, built alone into ``build/profile_k3/``
    at first use and called through its C entry point, in either design:
    weights packed once (``dfd_fused_mbconv_pack`` exported; called as this
    checkout's wrapper calls it, with the other build's own plans), or the
    one before, packing every call (``fused_mbconv.cu`` running K2's
    kernels, two SE kernels, a packing kernel and the gated projection; its
    C entry takes every scratch buffer)."""

    ARGTYPES = [ctypes.c_void_p] * 18 + [ctypes.c_int] * 9 + [ctypes.c_void_p]

    def __init__(self, tree: str):
        self.csrc = Path(tree) / "deepfakedetection_tpu_torch" / "ops" / "csrc"
        self.fn = None
        self.lib = None
        self.packed = False

    def _entry(self):
        from deepfakedetection_tpu_torch.ops import build

        if self.fn is None:
            digest = hashlib.sha256(" ".join(build.NVCC_FLAGS).encode())
            for src in sorted(self.csrc.glob("*.cu*")):
                digest.update(src.read_bytes())
            out = build.BUILD_DIR.parent / "profile_k3" / f"k3_{digest.hexdigest()[:16]}.so"
            if not out.exists():
                out.parent.mkdir(parents=True, exist_ok=True)
                subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-o", str(out),
                                str(self.csrc / "fused_mbconv.cu"),
                                str(self.csrc / "expand_dw.cu")], check=True)
            self.lib = ctypes.CDLL(str(out))
            self.packed = hasattr(self.lib, "dfd_fused_mbconv_pack")
            names = ("dfd_fused_mbconv_se", "dfd_fused_mbconv_pack", "dfd_fused_mbconv_plan",
                     "dfd_expand_dw_plan") if self.packed else ()
            for name in names:
                fn = getattr(self.lib, name)
                fn.argtypes, fn.restype = build._SIGNATURES[name], ctypes.c_int
            self.fn = self.lib.dfd_fused_mbconv_se
            if not self.packed:
                self.fn.argtypes, self.fn.restype = self.ARGTYPES, ctypes.c_int
        return self.fn

    def pack(self, w_exp, w_se_e, w_proj):
        """The weights packed by the other build (``fused_mbconv.pack``'s
        layouts), or None in the design that packs every call."""
        import torch

        from deepfakedetection_tpu_torch.ops import fused_mbconv as k3

        self._entry()
        if not self.packed:
            return None
        C, Cmid = w_exp.shape
        Cse, dev = w_se_e.shape[0], w_exp.device
        packed = k3.Packed(
            torch.empty((-(-Cmid // 64) * 64, -(-C // 16) * 8), dtype=torch.int32, device=dev),
            torch.empty((Cse, Cmid), dtype=torch.bfloat16, device=dev),
            torch.empty((C, -(-Cmid // k3.K_TILE) * k3.K_TILE), dtype=torch.bfloat16,
                        device=dev))
        rc = self.lib.dfd_fused_mbconv_pack(
            w_exp.data_ptr(), w_se_e.data_ptr(), w_proj.data_ptr(),
            *(t.data_ptr() for t in packed), C, Cmid, Cse, torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"the other tree's dfd_fused_mbconv_pack failed: CUDA error {rc}")
        return packed

    def plan(self, B, H, W, C, Cmid, kernel):
        """(K2's CB and RB, 1 for the wgmma projection, its BN, the device
        kernels a call launches) as the other build computes them."""
        from deepfakedetection_tpu_torch.ops import expand_dw as k2

        self._entry()
        k2p = (ctypes.c_int * 8)()
        rc = self.lib.dfd_expand_dw_plan(B, H, W, C, Cmid, kernel, k2.sm_count("cuda"), k2p)
        proj = (ctypes.c_int * 4)()
        rc = rc or self.lib.dfd_fused_mbconv_plan(C, Cmid, proj)
        if rc:
            raise RuntimeError(f"the other tree has no plan for {(B, H, W, C, Cmid, kernel)}")
        name = "gated_proj_kernel" if proj[0] == 1 else "gated_proj_mma_kernel"
        return (k2p[0], k2p[1], proj[0], proj[1],
                ("expand_dw_kernel", "se_reduce_kernel", "se_expand_kernel", name))

    def __call__(self, x, *weights, kernel: int, packed=None):
        import torch

        from deepfakedetection_tpu_torch.ops import expand_dw as k2

        if self._entry() and self.packed:
            return self._call_packed(x, weights, kernel, packed)
        B, H, W, C = x.shape
        Cmid, Cse = weights[0].shape[1], weights[4].shape[1]
        dev = x.device
        p = k2.plan(H, W, C, Cmid, kernel, B, k2.sm_count(dev))
        dw = torch.empty((B, H, W, Cmid), dtype=torch.bfloat16, device=dev)
        pool = torch.empty((B, Cmid), dtype=torch.float32, device=dev)
        wpack = torch.empty(k2.wpack_words(C, Cmid), dtype=torch.int32, device=dev)
        se_part = torch.empty((-(-Cmid // 256), B, Cse), dtype=torch.float32, device=dev)
        gate = torch.empty((B, Cmid), dtype=torch.bfloat16, device=dev)
        pairs = torch.empty((-(-Cmid // 32) * 16, -(-C // 64) * 64), dtype=torch.int32,
                            device=dev)
        out = torch.empty_like(x)
        rc = self._entry()(
            x.data_ptr(), *(t.data_ptr() for t in weights), dw.data_ptr(), pool.data_ptr(),
            wpack.data_ptr(), se_part.data_ptr(), gate.data_ptr(), pairs.data_ptr(),
            out.data_ptr(), B, H, W, C, Cmid, Cse, kernel, p.CB, p.RB,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"the other tree's dfd_fused_mbconv_se failed: CUDA error {rc}")
        return out

    def _call_packed(self, x, weights, kernel: int, packed):
        import torch

        B, H, W, C = x.shape
        w_exp, b_exp, w_dw, b_dw, w_se_r, b_se_r, w_se_e, b_se_e, w_proj, b_proj = weights
        Cmid, Cse, dev = w_exp.shape[1], w_se_r.shape[1], x.device
        CB, RB, wgmma, BN, _ = self.plan(B, H, W, C, Cmid, kernel)
        packed = packed or self.pack(w_exp, w_se_e, w_proj)
        out = torch.empty_like(x)
        scratch = (torch.empty((B, H, W, Cmid), dtype=torch.bfloat16, device=dev),
                   torch.empty((B, Cmid), dtype=torch.float32, device=dev),
                   torch.empty((-(-Cmid // 256), B, Cse), dtype=torch.float32, device=dev),
                   torch.empty((B, Cmid), dtype=torch.bfloat16, device=dev))
        rc = self.fn(
            x.data_ptr(), packed.wexp.data_ptr(), b_exp.data_ptr(), w_dw.data_ptr(),
            b_dw.data_ptr(), w_se_r.data_ptr(), b_se_r.data_ptr(), packed.see.data_ptr(),
            b_se_e.data_ptr(), packed.wpt.data_ptr(), b_proj.data_ptr(),
            *(t.data_ptr() for t in scratch), out.data_ptr(),
            B, H, W, C, Cmid, Cse, kernel, CB, RB, wgmma, BN,
            torch.cuda.current_stream().cuda_stream)
        if rc:
            raise RuntimeError(f"the other tree's dfd_fused_mbconv_se failed: CUDA error {rc}")
        return out


def turns(runs: dict, expect: dict) -> dict:
    """Each of ``runs``' time a call (median of 13 calls in each of the turns
    other, this, this, other), its device time a call (``chip_smoke.launch_ms``
    over 10 calls in each of the same turns, the mean; ``expect[name]`` are
    the kernels that run launches, once each) and each kernel's share of it
    (``kernel_split``, once a run)."""
    import chip_smoke as cs

    ms = {name: [] for name in runs}
    dev = {name: [] for name in runs}
    for name in ("other", "this", "this", "other"):
        ms[name] += cs.cuda_times(runs[name], runs=13)
        dev[name].append(cs.launch_ms(runs[name], expect[name]))
    row = {}
    for name in runs:
        split = cs.kernel_split(runs[name], expect=expect[name])[0]
        total = sum(split.values())
        row[f"{name}_ms"] = statistics.median(ms[name])
        row[f"{name}_device_ms"] = statistics.mean(dev[name])
        row[f"{name}_shares"] = {k: v / total for k, v in split.items()}
    return row


def compare(tree: str, shapes=None, odd=None) -> list[dict]:
    """This checkout's K3 against ``tree``'s: at ``shapes`` (default
    ``chip_smoke.K3_SHAPES``, batch 128) and ``odd`` (``chip_smoke.K3_ODD``,
    batch 8) both within two bf16 steps of the plain version's output scale
    and whether they are bit-identical; at ``shapes`` both timed in turns
    (``turns``)."""
    import chip_smoke as cs
    import torch

    from deepfakedetection_tpu_torch.ops import fused_mbconv as k3

    other, rows = Other(tree), []
    cases = [((H, W, C, k), 128, True) for H, W, C, k, _ in (shapes or cs.K3_SHAPES)]
    cases += [(s, 8, False) for s in (odd or cs.K3_ODD)]
    for i, ((H, W, C, k), B, timed) in enumerate(cases):
        args = cs.k3_inputs(B, H, W, C, k, seed=600 + i, device="cuda")
        packed = k3.pack(args[1], args[7], args[9])  # once, as MBConv does
        other_packed = other.pack(args[1], args[7], args[9])  # the same, where it packs at all
        runs = {"other": lambda: other(*args, kernel=k, packed=other_packed),
                "this": lambda: k3.fused_mbconv_se(*args, kernel=k, packed=packed)}
        ref = k3.fused_mbconv_se_plain(*args, kernel=k)
        plan = k3.plan(B, H, W, C, 6 * C, k, k3.k2.sm_count(args[0].device))
        outs = {}
        for name, fn in runs.items():
            outs[name] = fn()
            torch.cuda.synchronize()
            cs.check_close(f"{name} K3 {(B, H, W, C, k)}", outs[name], ref, cs.two_steps(ref),
                           0.0)
        diff = float((outs["other"].float() - outs["this"].float()).abs().max())
        row = {"shape": (H, W, C, k), "batch": B,
               "bit_identical": torch.equal(outs["other"], outs["this"]),
               "max_diff_bf16_steps": diff / max(cs.two_steps(ref) / 2, 1e-30),
               "plan": plan.describe()}
        if timed:
            expect = {"other": other.plan(B, H, W, C, 6 * C, k)[4] if other.packed
                      else PARENT_KERNELS, "this": plan.kernels()}
            row.update(turns(runs, expect))
        rows.append(row)
        text = (f"K3 {(B, H, W, C, k)} [{row['plan']}]: within two bf16 steps both; "
                f"bit-identical to {tree}'s {row['bit_identical']} "
                f"({row['max_diff_bf16_steps']:g} steps apart)")
        if timed:
            text += (f"; ms a call: this {row['this_ms']:.4f} (device "
                     f"{row['this_device_ms']:.4f}: " + shares(row["this_shares"])
                     + f"), {tree}'s {row['other_ms']:.4f} (device "
                     f"{row['other_device_ms']:.4f}: " + shares(row["other_shares"]) + ")")
        print(text, flush=True)
    return rows


def shares(split: dict) -> str:
    return ", ".join(f"{k} {v:.0%}" for k, v in sorted(split.items(), key=lambda kv: -kv[1]))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--tree", required=True,
                        help="compare with the K3 of the checkout in this directory")
    args = parser.parse_args()
    import chip_smoke as cs
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_k3: no CUDA card")
    print(cs.smi(), flush=True)
    compare(args.tree)


if __name__ == "__main__":
    main()
