"""The trainer: a head-only warmup, then the fine-tune, driven by the recipe.

Port of ``deepfakedetection_tpu/train/loop.py`` (``TrainJob``,
``run_training``): the same phases, hyperparameters, console lines,
``metrics.jsonl`` records, checkpoints and resume rules.

- Warmup: AdamW(3e-4, wd 5e-2) over the head (``_fc``) for
  ``warmup_epochs`` at the configured batch, then one validation.
- Fine-tune: AdamW(lr, wd) over the recipe's unfreeze set with the
  per-epoch cosine schedule, at micro-batch x accum folded into one batch
  (B3 and FasterViT: 32 x 4 = 128; ``docs/PARITY.md`` delta 2); validation on
  the trainer's val geometry after every epoch (the eval forward: K1 and K2
  for B3, K5 for FasterViT, K7 for EfficientFormerV2 on the card),
  ``latest.ckpt`` every epoch,
  ``best.ckpt`` and
  ``<weights_key>.pth`` on an improvement over +1e-4, early stopping,
  optional precise-BN recalibration and weight EMA.
- ``resume: auto`` restarts at the epoch after ``latest.ckpt``; a SIGTERM
  saves a mid-epoch ``latest.ckpt`` and sidecar, and the resumed run skips
  the batches already done. The loader order is fixed per epoch and every
  draw comes from a generator derived from (phase, epoch, batch), so the
  resumed run repeats the uninterrupted one.

The families are EfficientNet, FasterViT (whose train step runs K5's forward
and backward on the card, or K6's with ``DFD_FUSED_ATTN`` set) and
EfficientFormerV2 (built at the job's ``img_size``; its train step attends in
plain ops, its validation through K7); a FasterViT's head configuration comes
from its ``init_weights`` tensors unless the config pins one, as the eval job
picks it.

Options, as in the JAX package: ``training.remat`` recomputes the forward's
activations in the backward (``train/steps.train_step``);
``training.async_checkpoint`` writes the epoch-end checkpoints on a worker
thread (``runtime/checkpoint.AsyncSaver``), drained before a preemption save
and before the run returns or raises; ``profile_dir`` traces the whole run
with ``torch.profiler`` (CPU and CUDA activities) into a TensorBoard trace
there, for short runs.

Under a process group (``torchrun``, ``parallel/multihost.py``) each rank
trains on its shard of every epoch and every step is the global batch's
(``train/steps.train_step``): the batches are global, the warmup and eval
batches rounded up and the fine-tune batch down to a multiple of the
ranks, as the JAX loop does; the logged loss and validation accuracy are
the global ones, so every rank takes the same "best" and early-stop
decisions. Rank 0 writes the checkpoints, and a barrier follows each write
before any rank reads it (``runtime/checkpoint.py``). A ``mesh:`` with
``model > 1`` is refused (``parallel/mesh.MODEL_AXIS_ITEM``).
"""

from __future__ import annotations

import contextlib
import copy
from dataclasses import dataclass, field
from datetime import datetime
from pathlib import Path
from typing import Any

import numpy as np
import torch

from deepfakedetection_tpu_torch.data.augment import augment_batch
from deepfakedetection_tpu_torch.data.folder import require_num_classes, scan_image_folder
from deepfakedetection_tpu_torch.data.pipeline import (
    DeviceStager,
    make_eval_loader,
    make_train_loader,
    prefetch,
)
from deepfakedetection_tpu_torch.data.transforms import build_eval_plan, build_train_plan
from deepfakedetection_tpu_torch.evaluate.job import builder_kwargs, collect_probs, make_eval_step
from deepfakedetection_tpu_torch.parallel.mesh import MODEL_AXIS_ITEM, make_mesh, shard_batch
from deepfakedetection_tpu_torch.parallel.multihost import barrier
from deepfakedetection_tpu_torch.registry import ModelSpec
from deepfakedetection_tpu_torch.runtime import checkpoint as ckpt
from deepfakedetection_tpu_torch.runtime import preempt
from deepfakedetection_tpu_torch.runtime.convert import load_weights
from deepfakedetection_tpu_torch.runtime.logging import (
    append_metrics,
    console,
    progress,
    tee_output,
)
from deepfakedetection_tpu_torch.runtime.paths import RunPaths
from deepfakedetection_tpu_torch.runtime.seeding import (
    apply_seed,
    fold_in,
    fold_in_numpy,
    root_generator,
)
from deepfakedetection_tpu_torch.train.mixup import MixupSpec, sample_mix
from deepfakedetection_tpu_torch.train.optim import (
    PhaseOptimizer,
    epoch_cosine_schedule,
    head_predicate,
    unfreeze_predicate,
)
from deepfakedetection_tpu_torch.train.steps import EMA, recalibrate_bn, train_step

# Generator paths: (phase tag, epoch) for a phase's epoch, then the batch
# index for its augmentation, or STEP_TAG and the optimizer step for the
# step's dropout and drop-path masks.
WARMUP_TAG, FINETUNE_TAG, RECALC_TAG = 10_000, 20_000, 30_000
STEP_TAG, MIX_TAG = 0x5EED, 0x303


@dataclass
class TrainJob:
    """The JAX package's ``TrainJob`` fields, with a torch device and dtype."""

    model_name: str
    spec: ModelSpec
    run_paths: RunPaths
    data_root: Path
    device: torch.device = field(default_factory=lambda: torch.device("cpu"))
    train_split: str = "train"
    val_split: str = "val"
    num_classes: int = 2
    img_size: int = 224
    batch_size: int = 64
    epochs: int = 10
    num_workers: int = 4
    lr: float | None = None
    weight_decay: float | None = None
    accum_steps: int | None = None
    warmup_epochs: int | None = None
    early_stop_patience: int | None = None
    resume_auto: bool = False
    seed: int | None = None
    train_toggles: dict[str, Any] = field(default_factory=dict)
    eval_toggles: dict[str, Any] = field(default_factory=dict)
    compute_dtype: torch.dtype = torch.bfloat16
    profile_dir: str | None = None
    remat: bool = False
    bn_recalc_batches: int = 0
    cache_decoded: bool = False
    grad_clip_norm: float | None = None
    mixup_alpha: float = 0.0
    cutmix_alpha: float = 0.0
    class_weights: str | tuple[float, ...] | None = None
    ema_decay: float | None = None
    async_checkpoint: bool = False
    init_weights: Path | str | None = None
    unfreeze: str | tuple[str, ...] | None = None
    model_kwargs: dict[str, Any] = field(default_factory=dict)
    # the YAML mesh: block (parallel/mesh.py): data -1 or the process count
    mesh_data: int = -1
    mesh_model: int = 1


@dataclass
class TrainResult:
    best_val_acc: float
    best_epoch: int
    epochs_run: int
    final_train_loss: float
    # SIGTERM mid-run: a resumable checkpoint was saved
    interrupted: bool = False


def unported_options(job: TrainJob) -> list[str]:
    """What the port cannot run of the job, as refusal messages."""
    if job.mesh_model > 1:
        return [f"mesh model={job.mesh_model}: sharding parameters over a model axis is "
                f"{MODEL_AXIS_ITEM}"]
    return []


def resolve_class_weights(job: TrainJob, train_ds) -> np.ndarray | None:
    """[C] CE class weights: ``"auto"`` gives N / (C * count_c) over the
    train split, or the configured list (label = alphabetical class order)."""
    if job.class_weights is None:
        return None
    if isinstance(job.class_weights, str):
        if job.class_weights.lower() != "auto":
            raise SystemExit(
                f"training.class_weights must be 'auto' or a list of "
                f"{job.num_classes} positive floats, got {job.class_weights!r}"
            )
        counts = np.bincount(
            [label for _, label in train_ds.samples], minlength=job.num_classes
        ).astype(np.float64)
        w = counts.sum() / (job.num_classes * np.maximum(counts, 1.0))
    else:
        w = np.asarray(job.class_weights, np.float64)
        if w.shape != (job.num_classes,) or not (w > 0).all():
            raise SystemExit(
                f"training.class_weights needs {job.num_classes} positive "
                f"floats (got {job.class_weights!r})"
            )
    return w.astype(np.float32)


def apply_init_weights(model: torch.nn.Module, state: dict, path: Path) -> None:
    """Load the state dict of the torch ``.pth`` at ``path`` into a fresh
    model, strict=False: tensors whose name or shape differs (a swapped head)
    keep their init."""
    own = model.state_dict()
    matched = {k: v for k, v in state.items() if k in own and own[k].shape == v.shape}
    model.load_state_dict(matched, strict=False)
    unmatched = sorted(set(own) - set(matched))
    console.print(f"  init weights ← {path} ({len(own)} target tensors)")
    if unmatched:
        console.print(f"[yellow]  {len(unmatched)} unmatched (head swap / strict=False): "
                      f"{unmatched[:4]}…[/]")


def evaluate(model, loader, plan, stager, compute_dtype) -> tuple[float, float]:
    """(accuracy, img/s) over the valid rows of ``loader``, eval forward."""
    model.eval()
    probs, targets, speed = collect_probs(
        make_eval_step(model), loader, plan, stager, compute_dtype, desc="eval"
    )
    acc = float((probs.argmax(-1) == targets).mean()) if len(targets) else 0.0
    return acc, speed


def run_training(job: TrainJob) -> TrainResult:
    refused = unported_options(job)
    if refused:
        raise NotImplementedError("; ".join(refused))
    with (tee_output(job.run_paths.logs / "train.log"), preempt.trap(), profiled(job),
          checkpoint_saver(job) as saver):
        return _run_training(job, saver)


@contextlib.contextmanager
def checkpoint_saver(job: TrainJob):
    """The run's checkpoint writer: with ``async_checkpoint`` an
    ``AsyncSaver``, closed when the run ends (every submitted write lands,
    or its failure raises, before the run returns or raises); else an
    ``InlineSaver``."""
    saver = ckpt.AsyncSaver() if job.async_checkpoint else ckpt.InlineSaver()
    try:
        yield saver
    finally:
        saver.close()


def profiled(job: TrainJob):
    """With ``profile_dir``, a ``torch.profiler`` trace of the whole run
    (CPU, and CUDA on the card) written into it by
    ``tensorboard_trace_handler`` when the run ends; else nothing."""
    if not job.profile_dir:
        return contextlib.nullcontext()
    from torch.profiler import ProfilerActivity, profile, tensorboard_trace_handler

    activities = [ProfilerActivity.CPU]
    if job.device.type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    return profile(activities=activities,
                   on_trace_ready=tensorboard_trace_handler(str(job.profile_dir)))


def _counters(epoch: int, best_val_acc: float, best_epoch: int, warmup_done: bool) -> dict:
    return {"epoch": epoch, "best_val_acc": best_val_acc, "best_epoch": best_epoch,
            "warmup_done": warmup_done}


def _run_training(job: TrainJob, saver: ckpt.AsyncSaver | ckpt.InlineSaver) -> TrainResult:
    recipe = job.spec.recipe
    device = job.device
    mesh = make_mesh(job.mesh_data, job.mesh_model, device)
    n_data = mesh.data
    # the warmup and eval batch divides over the data axis: round up
    batch_size = -(-job.batch_size // n_data) * n_data
    apply_seed(job.seed)
    root = root_generator(job.seed)

    # ----- plans & data
    train_plan = build_train_plan(
        job.img_size, job.train_toggles,
        recipe_defaults=recipe.default_train_toggles, jitter_params=recipe.color_jitter,
    )
    eval_plan = build_eval_plan(job.img_size, job.eval_toggles, trainer_val=True)
    train_ds = scan_image_folder(job.data_root / job.train_split)
    val_ds = scan_image_folder(job.data_root / job.val_split)
    require_num_classes(train_ds, job.num_classes, split=job.train_split,
                        dataset_root=train_ds.root)
    class_w = resolve_class_weights(job, train_ds)
    if class_w is not None:
        console.print("  class-weighted CE: " + " ".join(f"{w:.3f}" for w in class_w))
        class_w = torch.from_numpy(class_w).to(device)

    # ----- model
    init_wpath = init_state = None
    if job.init_weights:
        init_wpath = Path(job.init_weights)
        if not init_wpath.exists():
            raise SystemExit(f"training.init_weights not found: {init_wpath}")
        # read even when resuming: latest.ckpt holds the configuration it picks
        init_state = load_weights(init_wpath, job.spec.family)
    model = job.spec.builder(
        job.num_classes, dtype=job.compute_dtype,
        generator=torch.Generator().manual_seed(0 if job.seed is None else int(job.seed)),
        **builder_kwargs(job.spec.family, job.model_kwargs, init_state, job.img_size),
    )
    if init_wpath is not None:
        if job.resume_auto and ckpt.has_latest(job.run_paths.checkpoints):
            console.print("  resume checkpoint present — skipping init_weights")
        else:
            apply_init_weights(model, init_state, init_wpath)
    model = model.to(device)
    named = list(model.named_parameters())
    console.print(
        f"[bold]→ training {job.model_name}[/] | params="
        f"{sum(p.numel() for _, p in named) / 1e6:.2f}M | device={device} | "
        f"mesh data={n_data} model={mesh.model}"
    )

    # ----- phase configuration
    warmup_epochs = job.warmup_epochs if job.warmup_epochs is not None else recipe.warmup_epochs
    ft_lr = job.lr if job.lr is not None else recipe.finetune_lr
    ft_wd = job.weight_decay if job.weight_decay is not None else recipe.finetune_weight_decay
    accum = recipe.accum_steps
    if recipe.accum_steps_overridable and job.accum_steps is not None:
        accum = max(1, job.accum_steps)
    micro = recipe.finetune_micro_batch or batch_size
    ft_batch = micro * accum
    if ft_batch > len(train_ds):
        ft_batch = max((len(train_ds) // micro) * micro, micro)
    ft_batch = max((ft_batch // n_data) * n_data, n_data)
    patience = (job.early_stop_patience if job.early_stop_patience is not None
                else recipe.early_stop_patience)
    epochs = job.epochs
    steps_per_epoch = max(len(train_ds) // max(ft_batch, 1), 1)

    stager = DeviceStager(device)

    def stage(batch, generator):
        images = stager(batch.images)
        x = augment_batch(images, generator, train_plan, out_dtype=job.compute_dtype)
        labels, mask = shard_batch(mesh, (batch.labels, batch.mask))
        return x, labels, mask

    def train_one_epoch(opt, loader, path, desc, *, mixup=None, on_step=None, skip=0):
        losses = []
        interrupted = False
        batches_done = skip
        batches = prefetch(
            loader, lambda batch, i: stage(batch, fold_in(root, *path, i, device=device)),
            device, skip=skip,
        )
        with progress(desc, total=len(loader.dataset)) as advance:
            for (x, labels, mask), num_valid in batches:
                mix = None
                if mixup is not None:
                    mix = sample_mix(fold_in_numpy(root, *path, MIX_TAG, opt.count), mixup,
                                     x.shape[2], x.shape[3])
                out = train_step(
                    model, opt, x, labels, mask,
                    fold_in(root, *path, STEP_TAG, opt.count, device=device),
                    label_smoothing=recipe.label_smoothing, class_weights=class_w, mix=mix,
                    remat=job.remat,
                )
                if on_step is not None:
                    on_step()
                losses.append(out["loss"])
                advance(num_valid)
                batches_done += 1
                if preempt.requested():
                    interrupted = True
                    break
            # a resumed partial epoch averages only the batches it ran; the
            # fetch waits for the device, so img/s counts the device's time
            mean_loss = float(torch.stack(losses).mean()) if losses else 0.0
            speed = advance(0) if losses else 0.0
        console.print(f"  {desc}: loss={mean_loss:.4f} | {speed:.1f} img/s")
        return mean_loss, speed, batches_done, interrupted

    eval_loader = make_eval_loader(
        val_ds, eval_plan, batch_size=batch_size, num_workers=job.num_workers,
        cache_decoded=job.cache_decoded,
    )

    best_val_acc, best_epoch, start_epoch, warmup_done, final_loss = 0.0, -1, 0, False, 0.0

    # ----- fine-tune optimizer (also the resume target)
    unfreeze_policy = job.unfreeze if job.unfreeze is not None else recipe.unfreeze
    ft_opt = PhaseOptimizer(
        named, lr=epoch_cosine_schedule(ft_lr, epochs, steps_per_epoch), weight_decay=ft_wd,
        trainable=unfreeze_predicate(unfreeze_policy), grad_clip_norm=job.grad_clip_norm,
    )
    if ft_opt.n_train == 0:
        raise SystemExit(
            f"training.unfreeze {unfreeze_policy!r} matches no parameter of "
            f"{job.model_name} — the fine-tune would train nothing"
        )

    # ----- auto-resume at an epoch boundary
    latest = ckpt.latest_path(job.run_paths.checkpoints)
    ema_shadow = None
    barrier()  # rank 0's last write has landed before any rank looks
    if job.resume_auto and latest.exists():
        state = ckpt.load(latest)
        model.load_state_dict(state["model"])
        ft_opt.load_state_dict(state["optimizer"])
        if job.ema_decay and state.get("ema") is not None:
            ema_shadow = state["ema"]
        c = state["counters"]
        start_epoch = int(c["epoch"]) + 1
        best_val_acc, best_epoch = float(c["best_val_acc"]), int(c["best_epoch"])
        warmup_done = bool(c["warmup_done"])
        console.print(f"  resumed from {latest} at epoch {start_epoch} "
                      f"(best={best_val_acc:.4f} @ {best_epoch})")

    # ----- mid-epoch resume (sidecar)
    resume_skip = 0
    prog = preempt.read_progress(job.run_paths.checkpoints) if job.resume_auto else None
    if (prog is not None and prog["epoch"] == start_epoch and prog["batch_size"] == ft_batch
            and prog["batches_done"] > 0):
        resume_skip = prog["batches_done"]
        console.print(f"  mid-epoch resume: skipping {resume_skip} completed batches "
                      f"of epoch {start_epoch + 1}")

    # ----- WARMUP phase
    if not warmup_done and warmup_epochs > 0 and start_epoch == 0:
        wu_opt = PhaseOptimizer(
            named, lr=recipe.warmup_lr, weight_decay=recipe.warmup_weight_decay,
            trainable=head_predicate(recipe.head_param_substrings),
            grad_clip_norm=job.grad_clip_norm,
        )
        console.print(f"  warmup: {warmup_epochs} epoch(s), head-only "
                      f"({wu_opt.n_train}/{wu_opt.n_total} param tensors) @ lr={recipe.warmup_lr}")
        wu_loader = make_train_loader(
            train_ds, train_plan, batch_size=batch_size, seed=job.seed,
            num_workers=job.num_workers, cache_decoded=job.cache_decoded,
        )
        for we in range(warmup_epochs):
            wu_loader.set_epoch(we)
            *_, wu_interrupted = train_one_epoch(
                wu_opt, wu_loader, (WARMUP_TAG + we,), f"warmup {we + 1}/{warmup_epochs}"
            )
            if wu_interrupted:
                console.print("  preempted during warmup — nothing saved; rerun restarts warmup")
                return TrainResult(0.0, -1, 0, 0.0, interrupted=True)
        acc, _ = evaluate(model, eval_loader, eval_plan, stager, job.compute_dtype)
        console.print(f"  warmup val acc={acc:.4f}")
        warmup_done = True

    # ----- FINE-TUNE phase
    console.print(
        f"  fine-tune: epochs={epochs} batch={ft_batch} (micro {micro} × accum {accum}) "
        f"lr={ft_lr} trainable={ft_opt.n_train}/{ft_opt.n_total} tensors"
    )
    mixup = None
    if job.mixup_alpha > 0.0 or job.cutmix_alpha > 0.0:
        mixup = MixupSpec(mixup_alpha=job.mixup_alpha, cutmix_alpha=job.cutmix_alpha)
        console.print(f"  mixup: alpha={job.mixup_alpha} cutmix={job.cutmix_alpha}")
    ft_loader = make_train_loader(
        train_ds, train_plan, batch_size=ft_batch, seed=job.seed,
        num_workers=job.num_workers, cache_decoded=job.cache_decoded,
    )

    params = [p for _, p in named]
    ema = eval_model = on_step = None
    if job.ema_decay:
        ema = EMA(params, float(job.ema_decay), shadow=ema_shadow)
        eval_model = copy.deepcopy(model)
        console.print(f"  weight EMA: decay={job.ema_decay}")

        def on_step():
            ema.update(params, ft_opt.count)

    def recalc_stats(target: torch.nn.Module, epoch: int) -> None:
        """Precise-BN pass over ``bn_recalc_batches`` train batches."""
        if job.bn_recalc_batches <= 0:
            return
        path = (RECALC_TAG + epoch,)

        def batches():
            ft_loader.set_epoch(90_000 + epoch)
            for i, batch in enumerate(ft_loader):
                if i >= job.bn_recalc_batches:
                    return
                yield stage(batch, fold_in(root, *path, i, device=device))[0]

        recalibrate_bn(target, batches(),
                       lambda i: fold_in(root, *path, STEP_TAG, i, device=device))

    def latest_state(done_epoch: int) -> dict:
        """``latest.ckpt``'s contents after epoch ``done_epoch``."""
        return {
            "counters": _counters(done_epoch, best_val_acc, best_epoch, True),
            "model": model.state_dict(),
            "optimizer": ft_opt.state_dict(),
            "ema": ema.shadow if ema is not None else None,
        }

    epochs_without_improvement = max(0, start_epoch - 1 - best_epoch)
    epoch = start_epoch - 1
    if job.async_checkpoint:
        console.print("  async checkpointing: epoch-end writes overlap compute")
    for epoch in range(start_epoch, epochs):
        ft_loader.set_epoch(epoch)
        skip = resume_skip if epoch == start_epoch else 0
        if skip >= len(ft_loader):
            skip = 0  # stale sidecar: replay the whole epoch
        final_loss, train_speed, batches_done, interrupted = train_one_epoch(
            ft_opt, ft_loader, (FINETUNE_TAG + epoch,), f"epoch {epoch + 1}/{epochs}",
            mixup=mixup, on_step=on_step, skip=skip,
        )
        if interrupted:
            # the counters still say the previous epoch completed; the
            # sidecar says how far this one got. Written here, after any
            # write in flight, so that latest.ckpt ends newest
            saver.wait()
            ckpt.save(latest, latest_state(epoch - 1))
            preempt.write_progress(job.run_paths.checkpoints, epoch=epoch,
                                   batches_done=batches_done, batch_size=ft_batch)
            console.print(f"  preempted at epoch {epoch + 1} batch {batches_done}: "
                          "mid-epoch checkpoint saved — rerun to resume exactly there")
            return TrainResult(best_val_acc, best_epoch, epoch - start_epoch, final_loss,
                               interrupted=True)
        recalc_stats(model, epoch)
        if ema is not None:
            # validate, select and export the averaged weights
            eval_model.load_state_dict(model.state_dict())
            with torch.no_grad():
                torch._foreach_copy_(list(eval_model.parameters()), ema.shadow)
            recalc_stats(eval_model, epoch)
            target = eval_model
        else:
            target = model
        acc, espeed = evaluate(target, eval_loader, eval_plan, stager, job.compute_dtype)
        improved = acc > best_val_acc + recipe.improvement_threshold
        if improved:
            best_val_acc, best_epoch, epochs_without_improvement = acc, epoch, 0
        else:
            epochs_without_improvement += 1
        console.print(f"  val acc={acc:.4f}{' ema' if ema is not None else ''} "
                      f"({espeed:.1f} img/s)" + (" ← best" if improved else ""))
        append_metrics(job.run_paths.logs / "metrics.jsonl", {
            "model": job.model_name, "split": "val", "epoch": epoch + 1,
            "train_loss": round(final_loss, 6), "train_img_s": round(train_speed, 1),
            "accuracy": acc, "best": improved, "timestamp": datetime.now().isoformat(),
        })
        state = latest_state(epoch)
        pth = job.run_paths.checkpoints / f"{job.spec.weights_key}.pth"
        saver.submit_tree(latest, state)
        # queued behind the write: the sidecar must not outlive the
        # checkpoint it refers to
        saver.submit_call(preempt.clear_progress, job.run_paths.checkpoints)
        if improved:
            saver.submit_tree(ckpt.best_path(job.run_paths.checkpoints), state)
            saver.submit_export(pth, target)
        if patience is not None and epochs_without_improvement >= patience:
            console.print(f"  early stop: no improvement for {patience} epochs")
            break
    return TrainResult(best_val_acc=best_val_acc, best_epoch=best_epoch,
                       epochs_run=epoch - start_epoch + 1, final_train_loss=final_loss)
