"""The port never imports JAX: in a fresh interpreter (tests/conftest.py
imports jax into this one), import the port's orchestrator, eval job, model
and kernel modules, run one CPU forward through the kernel wrappers, and
check that no jax, flax, optax or orbax module was loaded."""

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
assert model.kernel_launches_per_forward() == {"k1": 1, "k2": 5}
with torch.no_grad():
    out = model(torch.randn(2, 3, 32, 32, generator=torch.Generator().manual_seed(1)))
assert out.shape == (2, 2) and bool(torch.isfinite(out).all())
assert depthwise_se.depthwise_silu_pool.launches == expand_dw.expand_dw_silu_pool.launches == 0
banned = ("jax", "jaxlib", "flax", "optax", "orbax")
loaded = sorted(m for m in sys.modules if m.split(".")[0] in banned)
print("LOADED", loaded)
"""


def test_port_imports_no_jax():
    proc = subprocess.run(
        [sys.executable, "-c", SCRIPT], cwd=REPO, capture_output=True, text=True, timeout=300
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "LOADED []" in proc.stdout, proc.stdout
