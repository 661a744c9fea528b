"""What the data-parallel path costs a card: the bf16 B3 train step with
mixup at batch 128 through the ranked path (a world of one over NCCL)
against the plain step (no process group), the host's time a collective,
and where the ranked step's extra host time goes.

The ranked step adds, a step, one all-reduce of each BatchNorm's sums and
count forward and one backward (B3: 78 BatchNorms), two of the loss
normaliser, two all-gathers of mixup's partner row and labels, one of the
gradients and one of the logged loss and counts (``parallel/mesh.py``).
Each run is a process of its own (NCCL reads its settings when the group
is made): PyTorch's defaults and NCCL's flight recorder off
(``TORCH_FR_BUFFER_SIZE=0``; torch 2.11 still reads its older name,
``TORCH_NCCL_TRACE_BUFFER_SIZE``, with a warning), in turns (``ORDER``), as
the plain step's time moves by a fifth from one process to the next. Each
process times the plain step, the ranked one and the plain one again (CUDA
events, median of ``STEPS`` after 3 warm-up steps) and an 8-float
all-reduce (host clock, the mean of 200 calls, the device not waited for).
With ``--profile`` the first process also prints ``torch.profiler``'s table
of the ranked step by host time. Run on the card::

    python -m deepfakedetection_tpu_torch.profile_dp [--profile]

It prints one JSON line, with the card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import argparse
import json
import os
import socket
import statistics
import subprocess
import sys
import time

import torch

BATCH, STEPS = 128, 10
SETTINGS = {"default": {}, "no_flight_recorder": {"TORCH_FR_BUFFER_SIZE": "0"}}
ORDER = ("default", "no_flight_recorder", "no_flight_recorder", "default")


def _step(device: torch.device):
    """A seeded bf16 B3, its optimizer and one batch: a function that runs
    one train step with mixup."""
    from deepfakedetection_tpu_torch.models.efficientnet import create_efficientnet
    from deepfakedetection_tpu_torch.train.mixup import MixDraw
    from deepfakedetection_tpu_torch.train.optim import PhaseOptimizer, unfreeze_predicate
    from deepfakedetection_tpu_torch.train.steps import train_step

    g = torch.Generator().manual_seed(4)
    model = create_efficientnet("b3", num_classes=2, generator=g).to(device)
    opt = PhaseOptimizer(list(model.named_parameters()), lr=1e-4, weight_decay=5e-2,
                         trainable=unfreeze_predicate("all"))
    x = torch.randn(BATCH, 3, 224, 224, generator=g).to(device).to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    labels = (torch.arange(BATCH) % 2).to(device)
    mask = torch.ones(BATCH, dtype=torch.bool, device=device)
    masks = torch.Generator(device=device).manual_seed(0)
    return lambda: train_step(model, opt, x, labels, mask, masks, mix=MixDraw(False, 0.7))


def step_ms(device: torch.device) -> float:
    """The median CUDA-event time of ``STEPS`` steps after 3 warm-up steps."""
    step = _step(device)
    for _ in range(3):
        step()
    torch.cuda.synchronize()
    pairs = []
    for _ in range(STEPS):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        step()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def measure(profile: bool) -> dict:
    """This process's readings under the NCCL settings of its environment."""
    import torch.distributed as dist

    device = torch.device("cuda", 0)
    torch.cuda.set_device(device)
    out = {"plain_ms": step_ms(device)}
    dist.init_process_group("nccl", init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        t = torch.zeros(8, device=device)
        for _ in range(20):
            dist.all_reduce(t)
        torch.cuda.synchronize()
        start = time.perf_counter()
        for _ in range(200):
            dist.all_reduce(t)
        out["allreduce_host_us"] = (time.perf_counter() - start) / 200 * 1e6
        torch.cuda.synchronize()
        out["ranked_ms"] = step_ms(device)
        if profile:
            from torch.profiler import ProfilerActivity, profile as trace

            step = _step(device)
            for _ in range(3):
                step()
            torch.cuda.synchronize()
            with trace(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                for _ in range(3):
                    step()
                torch.cuda.synchronize()
            print(prof.key_averages().table(sort_by="self_cpu_time_total", row_limit=20),
                  file=sys.stderr, flush=True)
    finally:
        dist.destroy_process_group()
    out["plain_again_ms"] = step_ms(device)
    return out


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--profile", action="store_true",
                        help="print the ranked step's profiler table (first run)")
    parser.add_argument("--setting", choices=sorted(SETTINGS), help=argparse.SUPPRESS)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_dp needs a CUDA card")
    if args.setting:
        print(json.dumps(measure(args.profile)), flush=True)
        return
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    runs = []
    for i, name in enumerate(ORDER):
        argv = [sys.executable, "-m", "deepfakedetection_tpu_torch.profile_dp", "--setting", name]
        proc = subprocess.run(argv + (["--profile"] if args.profile and i == 0 else []),
                              env={**os.environ, **SETTINGS[name]}, capture_output=True,
                              text=True, check=False, timeout=600)
        if proc.returncode:
            raise SystemExit(f"profile_dp {name} failed:\n{proc.stderr[-3000:]}")
        sys.stderr.write(proc.stderr)
        runs.append({"setting": name, **json.loads(proc.stdout.strip().splitlines()[-1])})
    print(json.dumps({"card": card, "batch": BATCH, "runs": runs}))


if __name__ == "__main__":
    main()
