"""Throughput benchmark: eval or train images a second on one card.

Port of the root ``bench.py``, with its flags, refusals and metric names. Run
from the repository root::

    python -m deepfakedetection_tpu_torch.bench [--model NAME] [--mode eval|train]
        [--batch N] [--steps N] [--official] [--int8] [--tta] [--ema DECAY] [--mixup]
        [--conv-remat [full|save-conv]] [--pad-conv-stages]

It prints ONE JSON line:
``{"metric": ..., "value": N, "unit": "img/s/chip", "vs_baseline": null}``.
``bench.py``'s two baselines are TPU figures, so the port states none.

What it measures: synthetic resident batches (no decode), timed on the host
clock up to a value fetched from the card. The loop is eager PyTorch: every
step is dispatched from the host, so the host's dispatch is part of the time
(the JAX bench runs its whole loop on the device inside one jitted scan).

- eval: per-step inputs ``base + (seed + i) * 1e-6`` in bf16, the logits
  summed on the device, one ``.item()`` fetch as the barrier; a warm call,
  then the best of 3 trials of ``steps`` forwards. ``--int8`` runs under a
  uniform activation scale of 0.05 (throughput does not depend on the
  scale), depthwise convs included unless ``DFD_INT8_DW=0``.
- train: the port's train step (``train/steps.train_step``) with fused AdamW
  (lr 1e-4, weight decay 5e-2, every tensor trainable), ``max(steps // 3,
  5)`` steps a trial, the best of 2 trials after a warm one; ``--ema`` folds
  the EMA update into each step, ``--mixup`` draws Mixup/CutMix per step
  (``MixupSpec(0.2, 1.0)``, ``train/mixup``).
- FasterViT variants (``models/fastervit.py``): ``--conv-remat`` recomputes
  conv stages 1-2 in the backward (train only), ``--pad-conv-stages`` widens
  them to 128 / 256 channels (random weights).

``bench_eval`` and ``bench_train`` take ``img_size`` and ``device`` for
small runs on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import time

import numpy as np
import torch

from deepfakedetection_tpu_torch.evaluate.job import builder_kwargs
from deepfakedetection_tpu_torch.ops import quant
from deepfakedetection_tpu_torch.registry import get_model_spec
from deepfakedetection_tpu_torch.runtime.flags import resolve_device
from deepfakedetection_tpu_torch.train.mixup import MixupSpec, sample_mix
from deepfakedetection_tpu_torch.train.optim import PhaseOptimizer
from deepfakedetection_tpu_torch.train.steps import EMA, train_step


def _model(model_name: str, img_size: int, model_kwargs: dict | None, device: torch.device):
    spec = get_model_spec(model_name)
    kwargs = builder_kwargs(spec.family, model_kwargs or {}, None, img_size)
    model = spec.builder(2, dtype=torch.bfloat16, generator=torch.Generator().manual_seed(0),
                         **kwargs)
    return model.to(device)


def _inputs(batch: int, img_size: int, device: torch.device):
    """``base`` (bf16 ones, NCHW stored channels_last) and the step input
    ``base + (seed + i) * 1e-6``, the offset rounded to bf16 as the JAX
    bench computes it."""
    base = torch.ones((batch, 3, img_size, img_size), dtype=torch.bfloat16, device=device)
    base = base.contiguous(memory_format=torch.channels_last)

    def step_input(n: int) -> torch.Tensor:
        return base + float(torch.tensor(float(n), dtype=torch.bfloat16) * 1e-6)

    return step_input


def bench_eval(model_name: str = "efficientnet_b3", batch: int = 512, steps: int = 30,
               img_size: int = 224, model_kwargs: dict | None = None, int8: bool = False,
               tta: bool = False, device: str | None = None) -> float:
    """Eval images a second: the best of 3 trials of ``steps`` forwards of
    a bf16 model (two with ``tta``, the second over the width flip)."""
    dev = resolve_device({"device": device})
    model = _model(model_name, img_size, model_kwargs, dev).eval()
    step_input = _inputs(batch, img_size, dev)
    scope = (quant.quantized_eval(quant.QuantCtx(
        default_scale=0.05, include_depthwise=os.environ.get("DFD_INT8_DW", "1") != "0"))
        if int8 else contextlib.nullcontext())

    @torch.no_grad()
    def run(seed: int) -> float:
        total = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(steps):
            x = step_input(seed + i)
            logits = model(x)
            if tta:
                logits = logits + model(x.flip(3))
            total = total + logits.float().sum()
        return total.item()

    with scope:
        run(0)  # warm: kernel build, cuDNN and cuBLAS plans, int8 weights
        best = 0.0
        for trial in range(3):
            t0 = time.perf_counter()
            run(100 + trial)
            best = max(best, batch * steps / (time.perf_counter() - t0))
    return best


def bench_train(model_name: str = "efficientnet_b3", batch: int = 128, steps: int = 10,
                img_size: int = 224, model_kwargs: dict | None = None,
                ema_decay: float | None = None, mixup: bool = False,
                device: str | None = None) -> float:
    """Train images a second (forward, backward, fused AdamW over every
    tensor): the best of 2 trials of ``steps`` steps after a warm trial."""
    dev = resolve_device({"device": device})
    model = _model(model_name, img_size, model_kwargs, dev)
    named = list(model.named_parameters())
    params = [p for _, p in named]
    opt = PhaseOptimizer(named, lr=1e-4, weight_decay=5e-2, trainable=lambda _: True)
    ema = EMA(params, ema_decay, warmup=False) if ema_decay else None
    spec = MixupSpec(mixup_alpha=0.2, cutmix_alpha=1.0) if mixup else None
    mix_rng = np.random.default_rng(1)
    generator = torch.Generator(device=dev).manual_seed(1)
    step_input = _inputs(batch, img_size, dev)
    labels = torch.zeros((batch,), dtype=torch.long, device=dev)
    mask = torch.ones((batch,), dtype=torch.bool, device=dev)

    def run(seed: int) -> float:
        for i in range(steps):
            mix = sample_mix(mix_rng, spec, img_size, img_size) if spec else None
            out = train_step(model, opt, step_input(seed + i), labels, mask, generator, mix=mix)
            if ema is not None:
                ema.update(params, opt.count)
        return out["loss"].item()

    run(0)
    best = 0.0
    for trial in range(2):
        t0 = time.perf_counter()
        run(7 + trial)
        best = max(best, batch * steps / (time.perf_counter() - t0))
    return best


def parse_args(argv: list[str] | None = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--model", default="efficientnet_b3")
    parser.add_argument("--batch", type=int, default=128)
    parser.add_argument("--steps", type=int, default=30)
    parser.add_argument("--mode", choices=["eval", "train"], default="eval")
    parser.add_argument("--official", action="store_true",
                        help="FasterViT wheel-parity configuration (head_config='official')")
    parser.add_argument("--int8", action="store_true",
                        help="int8-quantized eval path (ops/quant.py; eval mode only)")
    parser.add_argument("--compiler-option", action="append", default=[], metavar="KEY=VAL",
                        help="XLA compiler override in the JAX bench; refused here")
    parser.add_argument("--ema", type=float, default=None, metavar="DECAY",
                        help="measure the weight-EMA training mode (training.ema_decay)")
    parser.add_argument("--tta", action="store_true",
                        help="measure hflip test-time augmentation (inference.tta; eval only)")
    parser.add_argument("--mixup", action="store_true",
                        help="measure in-step Mixup+CutMix (training extension; train only)")
    parser.add_argument("--conv-remat", nargs="?", const="full", default=None,
                        choices=["full", "save-conv"],
                        help="recompute FasterViT's conv stages 1-2 in the backward (train "
                             "only; the same numbers): 'full' the whole block, 'save-conv' only "
                             "the BatchNorm and GELU chains, keeping the conv outputs")
    parser.add_argument("--pad-conv-stages", action="store_true",
                        help="FasterViT with conv stages 1-2 at 128 / 256 channels in place of "
                             "96 / 192 (a benchmark variant: random weights, no checkpoint)")
    args = parser.parse_args(argv)
    if args.int8 and args.mode == "train":
        parser.error("--int8 is an eval-only path (training stays bf16)")
    if args.ema is not None and args.mode != "train":
        parser.error("--ema measures the training mode (use --mode train)")
    if args.tta and args.mode != "eval":
        parser.error("--tta is an eval-only path")
    if args.mixup and args.mode != "train":
        parser.error("--mixup is a train-only path")
    if args.compiler_option:
        parser.error("--compiler-option sets XLA's CompileOptions, which have no PyTorch "
                     "counterpart")
    if args.conv_remat:
        if "faster_vit" not in args.model:
            parser.error("--conv-remat is a FasterViT option")
        if args.mode != "train":
            parser.error("--conv-remat only affects the backward (train mode)")
    if args.pad_conv_stages and "faster_vit" not in args.model:
        parser.error("--pad-conv-stages is a FasterViT benchmark variant")
    return args


def main(argv: list[str] | None = None) -> None:
    args = parse_args(argv)
    kwargs = {"head_config": "official"} if args.official else {}
    suffix = "_official" if args.official else ""
    if args.conv_remat:
        kwargs["conv_remat"] = args.conv_remat
        suffix += "_convremat" if args.conv_remat == "full" else "_convrematsc"
    if args.pad_conv_stages:
        kwargs["conv_stage_dims"] = (128, 256)
        suffix += "_padconv"
    if args.int8:
        suffix += "_int8"
    if args.mode == "train":
        img_s = bench_train(args.model, args.batch, max(args.steps // 3, 5),
                            model_kwargs=kwargs, ema_decay=args.ema, mixup=args.mixup)
        if args.ema:
            suffix += "_ema"
        if args.mixup:
            suffix += "_mixup"
        metric = f"train_throughput_224px_{args.model}{suffix}"
    else:
        img_s = bench_eval(args.model, args.batch, args.steps, model_kwargs=kwargs,
                           int8=args.int8, tta=args.tta)
        if args.tta:
            suffix += "_tta"
        metric = f"eval_throughput_224px_{args.model}{suffix}"
    print(json.dumps({"metric": metric, "value": round(img_s, 1), "unit": "img/s/chip",
                      "vs_baseline": None}))


if __name__ == "__main__":
    main()
