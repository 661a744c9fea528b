"""Serialize a model's eval step for deployment (``torch.export``).

The port's counterpart of the root ``export.py`` (StableHLO through
``jax.export``). Run from the repository root::

    python -m deepfakedetection_tpu_torch.export --model efficientnet_b3 \\
        --weights runs/.../best.pth --out exports/efficientnet_b3.pt2 [--device cpu]

The artifact is the eval step ``softmax(model(x).float())`` as a
``torch.export`` program (``torch.export.save``): it takes the JAX artifact's
input, NHWC bf16 images ``[batch, img_size, img_size, 3]`` at a static batch,
and returns f32 probabilities ``[batch, num_classes]``. Inside, the input is
permuted to the port's channels_last NCHW view, at no copy. The weights go
beside it as a torch state dict at ``out.with_suffix(".weights.pth")``
(``runtime/checkpoint.export_weights``; the JAX export writes
``.weights.msgpack``). ``--weights`` takes a torch ``.pth`` or the JAX
package's flax msgpack weights (``runtime/convert.load_weights``). The program
is traced on the card unless ``--device cpu`` asks for the CPU; without a card
it raises.

The kernels are in the program as the ``torch.ops.dfd`` operators their
wrappers call (``ops/build.define_op``): ``load_exported`` imports only the
port's ``ops`` modules, which register those operators, and no model module,
so the program runs without the Python model code, as the JAX artifact does.
The operators' CUDA implementations launch the kernels from the library that
``ops/build.py`` builds.

The models cache values derived from their parameters (BN folded into the
convs, casts to the compute dtype, bias tables, K3's packed operands) in
``models/common.Derived``, keyed on the tensors' data pointers, which a
tracer's fake tensors do not have. The export runs one eager forward first,
which computes every such value, then traces under ``frozen_derived``, where
each ``Derived`` hands back the tensor it holds; ``torch.export`` keeps those
tensors as constants of the program. The values are computed once, eagerly,
by the same code as the eager eval step, and nothing is folded again a call,
so the program computes what the eager step computes: this was chosen over a
frozen copy of the model, a second path whose values would have to be held
equal to the first. Switches the model reads when it is built or traced are
baked into the program: ``DFD_FUSED_MBCONV`` (K3), ``DFD_FUSED_ATTN`` (K6)
and ``DFD_EXACT_GELU``.
"""

from __future__ import annotations

import argparse
import importlib
from pathlib import Path

import torch

# the modules whose import registers the torch.ops.dfd operators an eval
# program may call
OP_MODULES = tuple(f"deepfakedetection_tpu_torch.ops.{name}" for name in (
    "depthwise_se", "expand_dw", "fused_mbconv", "window_attn", "attn_block", "attn4d"))


class EvalProgram(torch.nn.Module):
    """The exported eval step: NHWC bf16 images -> f32 softmax
    probabilities, ``evaluate/job.make_eval_step``'s on the permuted view."""

    def __init__(self, model: torch.nn.Module) -> None:
        super().__init__()
        self.model = model

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        with torch.no_grad():
            return torch.softmax(self.model(x.permute(0, 3, 1, 2)).float(), dim=-1)


def export_program(model: torch.nn.Module, x: torch.Tensor) -> torch.export.ExportedProgram:
    """The eval step of ``model`` (on ``x``'s device, in eval mode) traced on
    the NHWC bf16 batch ``x``, whose shape the program keeps: one eager
    forward, then the trace under ``frozen_derived``."""
    from deepfakedetection_tpu_torch.models.common import frozen_derived

    program = EvalProgram(model).eval()
    program(x)  # computes every Derived value the trace hands back
    with frozen_derived():
        return torch.export.export(program, (x,), strict=False)


def export_model(
    model_name: str,
    weights: Path | None,
    out: Path,
    *,
    batch: int = 64,
    img_size: int = 224,
    num_classes: int = 2,
    device: str | None = None,
) -> Path:
    """Builds ``model_name`` through the eval job's ``load_model_for_eval``,
    traces its eval step at ``batch`` on ``device`` (the card unless "cpu")
    and writes the program to ``out`` and the weights beside it."""
    from deepfakedetection_tpu_torch.evaluate.job import EvalJob, load_model_for_eval
    from deepfakedetection_tpu_torch.registry import get_model_spec
    from deepfakedetection_tpu_torch.runtime.checkpoint import export_weights
    from deepfakedetection_tpu_torch.runtime.flags import resolve_device
    from deepfakedetection_tpu_torch.runtime.paths import RunPaths

    out = Path(out)
    dev = resolve_device({"device": device})
    job = EvalJob(
        model_name=model_name,
        spec=get_model_spec(model_name),
        run_paths=RunPaths(out.parent, out.parent, out.parent, out.parent),
        data_root=Path("."),
        device=dev,
        num_classes=num_classes,
        img_size=img_size,
        weights=weights,
    )
    model = load_model_for_eval(job)
    x = torch.zeros((batch, img_size, img_size, 3), dtype=torch.bfloat16, device=dev)
    exported = export_program(model, x)
    out.parent.mkdir(parents=True, exist_ok=True)
    torch.export.save(exported, out)
    export_weights(out.with_suffix(".weights.pth"), model)
    return out


def load_exported(path: str | Path, device: str | torch.device | None = None):
    """The program ``export_model`` wrote, as a callable module (NHWC bf16
    in, f32 probabilities out). Imports the port's ``ops`` modules, which
    register the operators it calls, and no model module. ``device`` moves
    the program's constants there; by default it runs where it was
    exported."""
    for name in OP_MODULES:
        importlib.import_module(name)
    exported = torch.export.load(Path(path))
    if device is not None:
        from torch.export.passes import move_to_device_pass

        exported = move_to_device_pass(exported, torch.device(device))
    return exported.module()


def main() -> None:
    parser = argparse.ArgumentParser(description="Export the eval step as a torch.export "
                                                 "program")
    parser.add_argument("--model", default="efficientnet_b3")
    parser.add_argument("--weights", type=Path, default=None)
    parser.add_argument("--out", type=Path, required=True)
    parser.add_argument("--batch", type=int, default=64)
    parser.add_argument("--img-size", type=int, default=224)
    parser.add_argument("--num-classes", type=int, default=2)
    parser.add_argument("--device", default=None,
                        help="cpu, or the CUDA card (the default; raises without one)")
    args = parser.parse_args()
    path = export_model(
        args.model, args.weights, args.out, batch=args.batch, img_size=args.img_size,
        num_classes=args.num_classes, device=args.device,
    )
    print(f"exported: {path} (+ {path.with_suffix('.weights.pth')})")


if __name__ == "__main__":
    main()
