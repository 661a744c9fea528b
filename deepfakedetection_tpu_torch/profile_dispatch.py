"""The host's cost of a kernel call through a registered operator.

The port's wrappers call their kernels through ``torch.ops.dfd`` operators
(``ops/build.define_op``), so that ``torch.export`` can record them. This
times what that costs a call on the card's host, in microseconds:

- a toy operation (``torch.empty_like``) called as a function, registered
  through the low-level route the port takes (``torch.library.Library``
  ``define`` + ``impl`` + ``register_fake``) and through the
  ``torch.library.custom_op`` decorator;
- K1 at B3's stage-0 shape at batch 1 (``K1_SHAPE``, a single-image
  prediction's): its CUDA implementation called directly (the ctypes launch,
  ``depthwise_se._cuda``), the operator, and the wrapper that models call.

Each figure is the host's time to enqueue a call: the best of ``ROUNDS``
rounds of ``CALLS`` calls after a warm-up, on the host clock, the device
drained before each round and not waited for inside it (``CALLS`` stays
below the card's launch queue, so the host never waits on the device: K1 at
batch 1 runs on one SM, ~0.16 ms a launch). Run on the card::

    python -m deepfakedetection_tpu_torch.profile_dispatch

It prints one JSON line, with the card's ``nvidia-smi`` name and power limit.
"""

from __future__ import annotations

import functools
import json
import subprocess
import time

import torch

K1_SHAPE = (1, 112, 112, 40, 3)  # B, H, W, C, k
CALLS = 200
ROUNDS = 10


@functools.cache
def _toy_ops():
    """The toy operation registered both ways (once a process)."""
    lib = torch.library.Library("dfd_probe", "FRAGMENT")
    lib.define("toy_library(Tensor x) -> Tensor")

    def toy(x: torch.Tensor) -> torch.Tensor:
        return torch.empty_like(x)

    lib.impl("toy_library", toy, "CUDA")
    torch.library.register_fake("dfd_probe::toy_library", toy, lib=lib)

    @torch.library.custom_op("dfd_probe::toy_custom", mutates_args=())
    def toy_custom(x: torch.Tensor) -> torch.Tensor:
        return torch.empty_like(x)

    toy_custom.register_fake(toy)
    return lib, toy, torch.ops.dfd_probe.toy_library, toy_custom


def us_a_call(fn, calls: int = CALLS, rounds: int = ROUNDS) -> float:
    """The best of ``rounds`` host times to enqueue ``calls`` calls, in µs a
    call; the device drains between rounds, outside the timing."""
    for _ in range(20):
        fn()
    best = float("inf")
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        best = min(best, (time.perf_counter() - t0) / calls * 1e6)
    torch.cuda.synchronize()
    return best


def measure(device: torch.device) -> dict[str, float]:
    """µs a call of each route (see the module's docstring)."""
    from deepfakedetection_tpu_torch.ops import depthwise_se as k1

    _, toy, toy_library, toy_custom = _toy_ops()
    small = torch.empty(8, device=device)
    B, H, W, C, k = K1_SHAPE
    g = torch.Generator().manual_seed(0)
    x = torch.randn(B, H, W, C, generator=g).to(device=device, dtype=torch.bfloat16)
    w = torch.randn(k, k, C, generator=g).to(device)
    b = torch.randn(C, generator=g).to(device)
    with torch.no_grad():
        return {
            "toy_function_us": us_a_call(lambda: toy(small)),
            "toy_library_us": us_a_call(lambda: toy_library(small)),
            "toy_custom_op_us": us_a_call(lambda: toy_custom(small)),
            "k1_direct_us": us_a_call(lambda: k1._cuda(x, w, b, k)),
            "k1_operator_us": us_a_call(lambda: torch.ops.dfd.depthwise_silu_pool(x, w, b, k)),
            "k1_wrapper_us": us_a_call(lambda: k1.depthwise_silu_pool(x, w, b, k=k)),
        }


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("profile_dispatch: needs a CUDA card")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    print(json.dumps({"card": card, "k1_shape": K1_SHAPE, "calls": CALLS, "rounds": ROUNDS,
                      **measure(torch.device("cuda", 0))}))


if __name__ == "__main__":
    main()
