"""The port never imports JAX or the JAX package: in a fresh interpreter
(tests/conftest.py imports jax into this one), import the port's
orchestrator, eval job, training modules, model and kernel modules, run one
CPU forward of a narrow EfficientNet through the K1/K2 wrappers, of one built
with ``DFD_FUSED_MBCONV`` through the K3 wrapper, of a narrow
FasterViT through the K5 wrapper, of one built with ``DFD_FUSED_ATTN`` through
the K6 wrapper (forward and backward) and of a narrow EfficientFormerV2
through the K7 wrapper, that EfficientFormerV2's train forward and backward
and its Grad-CAM, import the predict CLI and the web UI, serve a batch through
the server's micro-batcher and weigh an ensemble, import the data-parallel
modules (``parallel/mesh.py``, ``parallel/multihost.py``), one CPU train
step with the augmentation's shear rotation and one with ``remat``, a tree
packed into tar shards and read back through the eval loader, an
asynchronous checkpoint write, and a calibrated int8 forward
of the narrow EfficientNet through the int8 depthwise wrapper, import the
bench, export the narrow EfficientNet's eval step (``torch.export``, its K1
and K2 as ``torch.ops.dfd`` nodes) and read a msgpack map with the port's
flax reader, and check that no jax, flax, optax, orbax, msgpack or
ml_dtypes module and no ``deepfakedetection_tpu`` module was loaded. Statically, no
``.py`` file of the port imports either (``chip_smoke.reference_imports``)."""

import importlib.util
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]

SCRIPT = """
import sys
import torch
import deepfakedetection_tpu_torch.orchestrator
import deepfakedetection_tpu_torch.evaluate.job
import deepfakedetection_tpu_torch.ops.build
import deepfakedetection_tpu_torch.profile_forward
from deepfakedetection_tpu_torch.models.efficientnet import EfficientNet
from deepfakedetection_tpu_torch.ops import depthwise_se, expand_dw

model = EfficientNet(num_classes=2, width_coefficient=0.25, depth_coefficient=0.5,
                     native_resolution=32, generator=torch.Generator().manual_seed(0)).eval()
assert model.kernel_launches_per_forward() == {"k1": 1, "k2": 5, "k3": 0}
with torch.no_grad():
    out = model(torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(1)))
assert out.shape == (2, 2) and bool(torch.isfinite(out).all())
assert depthwise_se.depthwise_silu_pool.launches == expand_dw.expand_dw_silu_pool.launches == 0

import os
from deepfakedetection_tpu_torch.ops import fused_mbconv

os.environ["DFD_FUSED_MBCONV"] = "1"
whole = EfficientNet(num_classes=2, width_coefficient=0.25, depth_coefficient=0.5,
                     native_resolution=32, generator=torch.Generator().manual_seed(0)).eval()
del os.environ["DFD_FUSED_MBCONV"]
assert whole.kernel_launches_per_forward() == {"k1": 1, "k2": 2, "k3": 3}
with torch.no_grad():
    out = whole(torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(1)))
assert out.shape == (2, 2) and bool(torch.isfinite(out).all())
assert fused_mbconv.fused_mbconv_se.launches == 0

import deepfakedetection_tpu_torch.runtime.checkpoint
import deepfakedetection_tpu_torch.runtime.preempt
import deepfakedetection_tpu_torch.train.loop
import deepfakedetection_tpu_torch.parallel.mesh
import deepfakedetection_tpu_torch.parallel.multihost
from deepfakedetection_tpu_torch.parallel.mesh import make_mesh

assert make_mesh(-1, 1).world == 1
from deepfakedetection_tpu_torch.data.augment import augment_batch
from deepfakedetection_tpu_torch.data.pipeline import build_train_plan
from deepfakedetection_tpu_torch.ops import shear_rotate
from deepfakedetection_tpu_torch.runtime.seeding import fold_in, root_generator
from deepfakedetection_tpu_torch.train.optim import PhaseOptimizer, unfreeze_predicate
from deepfakedetection_tpu_torch.train.steps import train_step

plan = build_train_plan(72, {}, jitter_params=(0.2, 0.2, 0.2, 0.05))
assert plan.rotation and plan.rotation_degrees == 10.0
root = root_generator(3)
canvas = torch.randint(0, 256, (4, plan.host_canvas_size, plan.host_canvas_size, 3),
                       generator=fold_in(root, 1), dtype=torch.uint8)
x = augment_batch(canvas, fold_in(root, 2), plan, torch.bfloat16)
opt = PhaseOptimizer(list(model.named_parameters()), lr=1e-4, weight_decay=5e-2,
                     trainable=unfreeze_predicate("all"))
out = train_step(model, opt, x, torch.tensor([0, 1, 0, 1]), torch.ones(4, dtype=torch.bool),
                 fold_in(root, 3))
assert bool(torch.isfinite(out["loss"])) and opt.count == 1
assert shear_rotate.rotate_batch.launches == 0
out = train_step(model, opt, x, torch.tensor([0, 1, 0, 1]), torch.ones(4, dtype=torch.bool),
                 fold_in(root, 4), remat=True)
assert bool(torch.isfinite(out["loss"])) and opt.count == 2

import tempfile
from pathlib import Path
from PIL import Image
from deepfakedetection_tpu_torch.data.folder import scan_image_folder
from deepfakedetection_tpu_torch.data.pipeline import build_eval_plan, make_eval_loader
from deepfakedetection_tpu_torch.data.shards import write_shards
from deepfakedetection_tpu_torch.runtime.checkpoint import AsyncSaver, load

with tempfile.TemporaryDirectory() as tmp:
    tree = Path(tmp) / "tree"
    for cls in ("fake", "real"):
        (tree / cls).mkdir(parents=True)
        color = "white" if cls == "real" else "black"
        Image.new("RGB", (40, 36), color).save(tree / cls / "a.png")
    write_shards(scan_image_folder(tree), Path(tmp) / "shards")
    batch = next(iter(make_eval_loader(scan_image_folder(Path(tmp) / "shards"),
                                       build_eval_plan(32, {}), batch_size=2)))
    assert batch.images.shape == (2, 32, 32, 3) and batch.mask.all()
    assert batch.images[0].max() == 0 and batch.images[1].min() == 255
    saver = AsyncSaver()
    saver.submit_tree(Path(tmp) / "a.ckpt", {"w": torch.ones(2)})
    saver.close()
    assert torch.equal(load(Path(tmp) / "a.ckpt")["w"], torch.ones(2))

from deepfakedetection_tpu_torch.models.fastervit import FasterViT
from deepfakedetection_tpu_torch.ops import window_attn

vit = FasterViT(2, dim=16, in_dim=8, depths=(1, 1, 1, 1),
                generator=torch.Generator().manual_seed(0)).eval()
assert vit.kernel_launches_per_forward() == {"k5": 2, "k6": 0}
calls = []
plain = window_attn.window_attention_plain
window_attn.window_attention_plain = lambda *a, **kw: calls.append(a[0].shape[1]) or plain(*a, **kw)
with torch.no_grad():
    out = vit(torch.randn(2, 3, 224, 224, generator=torch.Generator().manual_seed(1)))
window_attn.window_attention_plain = plain
assert out.shape == (2, 2) and bool(torch.isfinite(out).all())
assert calls == [53, 49] and window_attn.window_attention.launches == 0, calls

import os
from deepfakedetection_tpu_torch.ops import attn_block

os.environ["DFD_FUSED_ATTN"] = "1"
fused = FasterViT(2, dim=16, in_dim=8, depths=(1, 1, 1, 1),
                  generator=torch.Generator().manual_seed(0))
del os.environ["DFD_FUSED_ATTN"]
assert fused.kernel_launches_per_forward() == {"k5": 0, "k6": 3}
fused_calls = []
plain6 = attn_block.attn_subblock_plain
attn_block.attn_subblock_plain = lambda *a, **kw: fused_calls.append(a[0].shape[1]) or plain6(*a, **kw)
out = fused(torch.randn(2, 3, 224, 224, generator=torch.Generator().manual_seed(1)),
            torch.Generator().manual_seed(2))
out.sum().backward()
attn_block.attn_subblock_plain = plain6
assert out.shape == (2, 2) and bool(torch.isfinite(out).all())
assert fused.levels[3].blocks[0].attn.qkv.weight.grad is not None
assert fused_calls == [16, 53, 49] and attn_block.attn_subblock.launches == 0, fused_calls
assert attn_block.attn_subblock_bwd.launches == 0

from deepfakedetection_tpu_torch.models.efficientformer_v2 import EfficientFormerV2
from deepfakedetection_tpu_torch.ops import attn4d

ef = EfficientFormerV2(2, dims=(16, 24, 32, 48), depths=(1, 1, 2, 2), vit_num=1,
                       e_ratios={0: [4], 1: [4], 2: [4, 4], 3: [4, 4]}, img_size=64,
                       generator=torch.Generator().manual_seed(0)).eval()
assert ef.kernel_launches_per_forward() == {"k7": 2}
tokens = []
plain4d = attn4d.attn4d_plain
attn4d.attn4d_plain = lambda *a, **kw: tokens.append(a[0].shape[1]) or plain4d(*a, **kw)
with torch.no_grad():
    out = ef(torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(1)))
attn4d.attn4d_plain = plain4d
assert out.shape == (2, 2) and bool(torch.isfinite(out).all())
assert tokens == [4, 4] and attn4d.attn4d.launches == 0, tokens

ef.train()
out = ef(torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(2)))
out.sum().backward()
th = ef.stages[3].blocks[1].token_mixer.talking_head2.weight
assert bool(torch.isfinite(out).all()) and th.grad is not None and bool(th.grad.abs().sum() > 0)
assert attn4d.attn4d.launches == 0
ef.eval()

import deepfakedetection_tpu_torch.predict
import deepfakedetection_tpu_torch.web_ui
import numpy as np
from deepfakedetection_tpu_torch.evaluate.ensemble import weighted_mean
from deepfakedetection_tpu_torch.serve import MicroBatcher

batcher = MicroBatcher(lambda b: np.ones((len(b), 2)) / 2, max_batch=4, name="no_jax")
assert batcher.submit(np.zeros((2, 2, 3), np.uint8)).result(timeout=30).tolist() == [0.5, 0.5]
batcher.stop()
assert weighted_mean([("a", np.ones(2)), ("b", np.zeros(2))], {"a": 3.0}).tolist() == [0.75] * 2
from deepfakedetection_tpu_torch.cam import compute_cam

cam = compute_cam(ef, torch.randn(2, 3, 64, 64, generator=torch.Generator().manual_seed(3)), 1)
assert cam.shape == (2, 64, 64) and bool(torch.isfinite(cam).all())
import deepfakedetection_tpu_torch.bench
from deepfakedetection_tpu_torch.ops import int8_dw, quant

model.eval()
images = torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(4))
scales = quant.calibrate_act_scales(model, [images], mode="percentile")
with quant.quantized_eval(quant.QuantCtx(scales=scales)), torch.no_grad():
    assert model.kernel_launches_per_forward() == {"k1": 0, "k2": 0, "k3": 0}
    out = model(images)
assert out.shape == (2, 2) and bool(torch.isfinite(out).all())
assert int8_dw.int8_depthwise.launches == 0

from deepfakedetection_tpu_torch.export import export_program
from deepfakedetection_tpu_torch.runtime import flax_msgpack

program = export_program(model, torch.randn(2, 32, 32, 3).to(torch.bfloat16))
nodes = [str(n.target) for gm in program.graph_module.modules()
         if isinstance(gm, torch.fx.GraphModule) for n in gm.graph.nodes]
assert nodes.count("dfd.depthwise_silu_pool.default") == 1, nodes
assert nodes.count("dfd.expand_dw_silu_pool.default") == 5, nodes
assert flax_msgpack.msgpack_restore(bytes([0x81, 0xA1, 0x61, 0xC0])) == {"a": None}
banned = ("jax", "jaxlib", "flax", "optax", "orbax", "msgpack", "ml_dtypes",
          "deepfakedetection_tpu")
loaded = sorted(m for m in sys.modules if m.split(".")[0] in banned)
print("LOADED", loaded)
"""


def test_port_imports_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout, proc.stdout


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_no_port_module_imports_jax_or_the_jax_package():
    smoke = _chip_smoke()
    files = sorted((REPO / "deepfakedetection_tpu_torch").rglob("*.py"))
    assert len(files) > 30
    found = {str(f.relative_to(REPO)): smoke.reference_imports(f.read_text()) for f in files}
    assert {f: names for f, names in found.items() if names} == {}


def test_chip_smoke_imports_nothing_of_the_jax_package():
    """The card's script goes through the port only; its own check finds a
    planted import."""
    smoke = _chip_smoke()
    assert smoke.reference_imports((REPO / "chip_smoke.py").read_text()) == []
    planted = "def f():\n    from deepfakedetection_tpu.data.transforms import build_train_plan\n"
    assert smoke.reference_imports(planted) == ["deepfakedetection_tpu.data.transforms"]
    assert smoke.reference_imports("import deepfakedetection_tpu_torch.ops, optax") == ["optax"]
