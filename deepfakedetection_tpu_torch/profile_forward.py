"""Where the device time of an eval forward, or of a train step, goes, per
op, on one CUDA card.

    python -m deepfakedetection_tpu_torch.profile_forward            # B3 eval forward
    python -m deepfakedetection_tpu_torch.profile_forward --train    # B3 train step
    python -m deepfakedetection_tpu_torch.profile_forward --model faster_vit_2_224 \
        [--head-config official|tpu] [--train]       # FasterViT-2 forward or train step
    python -m deepfakedetection_tpu_torch.profile_forward --model efficientformerv2_s1 [--train]
    DFD_FUSED_ATTN=1 python -m deepfakedetection_tpu_torch.profile_forward \
        --model faster_vit_2_224 [--train]           # FasterViT-2 through K6
    DFD_FUSED_MBCONV=1 python -m deepfakedetection_tpu_torch.profile_forward
                                                     # B3's residual blocks through K3

Runs the model at 224 px in bf16 with generator-seeded weights (the times do
not depend on their values): B3 at batch 128, FasterViT-2's and
EfficientFormerV2-S1's forwards at their eval configs' batch 256, FasterViT-2's
train step at the fine-tune batch 128 (32 x 4 folded) and EfficientFormerV2-S1's
at its configured batch 128, and traces 5 calls after 3 warm-up ones with
``torch.profiler``.
The train step is the training path's fine-tune step: forward with batch
statistics, dropout and drop-path, backward (FasterViT: K5's forward and
backward kernels; EfficientFormerV2: plain attention, no K7), and AdamW over
every tensor. Prints the device time per call against the wall time per call (host clock, device
synchronised), so their gap is the device's idle time, then each device
kernel's self time and launches per call, the largest first, the port's
hand-written kernels tagged with the TPU kernel each replaces (K1-K7). K3's
first kernel is K2's, so with ``DFD_FUSED_MBCONV`` the K2 rows count those
launches too and the K3 rows are its SE and gated-projection kernels (and its
packing kernel, once a model). This is the breakdown behind ``PERF.md``
section 5.
"""

from __future__ import annotations

import argparse
import time

import torch
from torch.profiler import ProfilerActivity, profile

from deepfakedetection_tpu_torch.models.efficientformer_v2 import create_efficientformer_v2
from deepfakedetection_tpu_torch.models.efficientnet import create_efficientnet
from deepfakedetection_tpu_torch.models.fastervit import create_faster_vit
from deepfakedetection_tpu_torch.ops import window_attn
from deepfakedetection_tpu_torch.runtime.seeding import fold_in, root_generator
from deepfakedetection_tpu_torch.train.optim import PhaseOptimizer, unfreeze_predicate
from deepfakedetection_tpu_torch.train.steps import train_step

CALLS, WARMUP, ROWS = 5, 3, 30
# the port's CUDA kernels (ops/csrc) by the TPU kernel each replaces
TAGS = {"depthwise_silu_pool_kernel": "K1", "expand_dw_kernel": "K2", "pack_wexp_kernel": "K2",
        "se_reduce_kernel": "K3", "se_expand_kernel": "K3", "gated_proj_kernel": "K3",
        "gated_proj_mma_kernel": "K3", "pack_kernel": "K3",
        "shear_rotate_kernel": "K4", **dict.fromkeys(window_attn.FWD_KERNELS, "K5"),
        **dict.fromkeys(window_attn.BWD_KERNELS, "K5 bwd"),
        "attn_qkv_kernel": "K6", "window_bwd_kernel": "K6 bwd", "sum_partials_kernel": "K6 bwd",
        "attn4d_kernel": "K7"}
# K6's GEMM (csrc/gemm_tma.cuh) by its epilogue: the forward's projection, or
# the backward's dctx, dx and weight gradients
GEMM_TAGS = {"ProjEpi": "K6", "StoreEpi": "K6 bwd", "WgradEpi": "K6 bwd"}


def tag(kernel: str) -> str:
    """The TPU kernel a device kernel's name says it replaces, or ""."""
    if "gemm_kernel<" in kernel:
        return next((t for k, t in GEMM_TAGS.items() if f"::{k}>" in kernel), "")
    return next((t for k, t in TAGS.items() if f"{k}<" in kernel or f"{k}(" in kernel), "")
BATCH = {"efficientnet_b3": 128, "faster_vit_2_224": 256, "efficientformerv2_s1": 256}
TRAIN_BATCH = {"efficientnet_b3": 128, "faster_vit_2_224": 128, "efficientformerv2_s1": 128}


def _call(model, x, train: bool):
    if not train:
        model.eval()

        def forward():
            with torch.no_grad():
                model(x)

        return forward
    opt = PhaseOptimizer(list(model.named_parameters()), lr=1e-4, weight_decay=5e-2,
                         trainable=unfreeze_predicate("all"))
    labels = (torch.arange(len(x)) % 2).to(x.device)
    mask = torch.ones(len(x), dtype=torch.bool, device=x.device)
    root = root_generator(0)
    return lambda: train_step(model, opt, x, labels, mask,
                              fold_in(root, opt.count, device=x.device))


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--train", action="store_true", help="profile the train step")
    parser.add_argument("--model", choices=list(BATCH), default="efficientnet_b3")
    parser.add_argument("--head-config", choices=("official", "tpu"), default="official",
                        help="FasterViT's head configuration")
    args = parser.parse_args()
    train = args.train
    batch = (TRAIN_BATCH if train else BATCH)[args.model]
    if not torch.cuda.is_available():
        raise SystemExit("profile_forward: needs a CUDA card")
    g = torch.Generator().manual_seed(0)
    if args.model == "efficientnet_b3":
        model = create_efficientnet("b3", num_classes=2, dtype=torch.bfloat16, generator=g)
        name = "B3"
    elif args.model == "efficientformerv2_s1":
        model = create_efficientformer_v2("s1", generator=g)
        name = "EfficientFormerV2-S1"
    else:
        model = create_faster_vit("2", head_config=args.head_config, generator=g)
        name = f"FasterViT-2 {args.head_config}"
    model = model.cuda()
    x = torch.randn(batch, 3, 224, 224, generator=g).cuda().to(torch.bfloat16)
    x = x.contiguous(memory_format=torch.channels_last)
    call = _call(model, x, train)
    for _ in range(WARMUP):
        call()
    torch.cuda.synchronize()
    start = time.perf_counter()
    for _ in range(CALLS):
        call()
    torch.cuda.synchronize()
    plain_wall = (time.perf_counter() - start) / CALLS * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        for _ in range(CALLS):
            call()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - start) / CALLS * 1e3
    kernels = sorted(
        (
            (e.self_device_time_total / CALLS / 1e3, e.count / CALLS, e.key)
            for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA
        ),
        reverse=True,
    )
    device_ms = sum(k[0] for k in kernels)
    host_ops = sum(e.count for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CPU
                   and e.key.startswith("aten::")) / CALLS
    what = "train step" if train else "forward"
    print(f"{name} {what}, batch {batch}, bf16 ({torch.cuda.get_device_name(0)}): "
          f"{device_ms:.3f} ms of device time per call; wall time {plain_wall:.3f} ms "
          f"({wall:.3f} ms under the profiler); {host_ops:.0f} aten op calls per call (nested ones included)")
    print(f"{'ms':>8} {'calls':>6} {'port':>6}  kernel")
    for ms, calls, name in kernels[:ROWS]:
        print(f"{ms:8.3f} {calls:6.1f} {tag(name):>6}  {name[:110]}")


if __name__ == "__main__":
    main()
