"""Where the device time of the B3 eval forward goes, per op, on one CUDA card.

    python -m deepfakedetection_tpu_torch.profile_forward

Runs EfficientNet-B3 at 224 px, batch 128, bf16, with generator-seeded
weights (the times do not depend on their values), and traces 5 forwards
after 3 warm-up ones with ``torch.profiler``. Prints the device time per
forward, then each device kernel's self time and launches per forward, the
largest first. This is the breakdown behind ``PERF.md`` section 5.
"""

from __future__ import annotations

import torch
from torch.profiler import ProfilerActivity, profile

from deepfakedetection_tpu_torch.models.efficientnet import create_efficientnet

BATCH, FORWARDS, WARMUP, ROWS = 128, 5, 3, 30


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward: needs a CUDA card")
    g = torch.Generator().manual_seed(0)
    model = create_efficientnet("b3", num_classes=2, dtype=torch.bfloat16, generator=g)
    model = model.cuda().eval()
    x = torch.randn(BATCH, 3, 224, 224, generator=g).cuda().to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    with torch.no_grad():
        for _ in range(WARMUP):
            model(x)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(FORWARDS):
                model(x)
            torch.cuda.synchronize()
    kernels = sorted(
        (
            (e.self_device_time_total / FORWARDS / 1e3, e.count / FORWARDS, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
        ),
        reverse=True,
    )
    print(f"B3 forward, batch {BATCH}, bf16: {sum(k[0] for k in kernels):.3f} ms of device "
          f"time per forward ({torch.cuda.get_device_name(0)})")
    print(f"{'ms':>8} {'calls':>6}  kernel")
    for ms, calls, name in kernels[:ROWS]:
        print(f"{ms:8.3f} {calls:6.1f}  {name[:110]}")


if __name__ == "__main__":
    main()
