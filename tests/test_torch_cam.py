"""The port's Grad-CAM (deepfakedetection_tpu_torch/cam.py) against the JAX
package's ``deepfakedetection_tpu/cam.py`` and an independent hook-based
reference, on the CPU.

(a) ``head_logits`` on a model's ``cam_features`` map gives the model's own
    logits, bit for bit, for every family in f32 and bf16: the forward is
    the head applied to that map.
(b) The port's ``compute_cam`` against the JAX ``compute_cam``, f32 (JAX at
    "highest" matmul precision), on one numpy-seeded tree in both packages
    (``state_dict_from_jax``): the narrow B3 at 128 px, the narrow FasterViT
    (dim 16, depths (1, 1, 2, 1), 224 px) in both head configurations and
    the narrow EfficientFormerV2 at 128 px, batch 2, both classes. The
    [0, 1] maps within 1e-3 [measured at most 2.5e-6: B3 1.9e-6, FasterViT
    official 2.5e-6 and tpu 1.3e-6, EfficientFormerV2 2.0e-6], and the
    overlays within ``tests/test_cam_parity.py``'s byte gate for that CAM
    gate (255 * 0.5 * 4 * 1e-3, rounded up, plus one) [measured 1 byte].
    Class 1's maps are live in every family; class 0's may be ReLU'd to zero
    (B3's are: every weighted channel sum is negative), equal in both.
(c) EfficientFormerV2-S1 at full width against
    ``tests/torch_refs/gradcam_torch.py``: its forward hook on the timm-layout
    reference's final ``norm`` (``tests/torch_refs/efficientformer_v2_torch.py``,
    seeded statistics, layer scales, talking heads and tables), its backward
    through the whole reference, the port from the same state dict (erf
    GELU on both sides), f32: within 1e-3 [measured 1.5e-5], overlays within
    the byte gate. The JAX package has no EfficientFormerV2 case of its own.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepfakedetection_tpu.cam import compute_cam as jax_compute_cam
from deepfakedetection_tpu.cam import show_cam_on_image as jax_overlay
from deepfakedetection_tpu.models.efficientformer_v2 import EfficientFormerV2 as JaxEFv2
from deepfakedetection_tpu.models.efficientnet import EfficientNet as JaxEfficientNet
from deepfakedetection_tpu.models.fastervit import FasterViT as JaxFasterViT
from deepfakedetection_tpu.train.steps import init_model_variables
from deepfakedetection_tpu_torch.cam import compute_cam, head_logits, show_cam_on_image
from tests import test_torch_efficientformer_v2 as ef_tests
from tests import test_torch_efficientnet as b3_tests
from tests import test_torch_fastervit as fv_tests
from tests.test_torch_efficientformer_v2 import _perturbed_ref
from tests.torch_refs.gradcam_torch import TorchGradCAM
from tests.torch_refs.gradcam_torch import show_cam_on_image as ref_overlay

CAM_GATE = 1e-3
BYTE_GATE = int(np.ceil(255.0 * 0.5 * 4.0 * CAM_GATE)) + 1
FAMILIES = ["b3", "fastervit_official", "fastervit_tpu", "efficientformerv2"]


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads while this file runs: the suite runs one file a
    worker on a few cores, and the port's many small CPU ops slow down by
    an order of magnitude when every worker's pool spans every core."""
    before = torch.get_num_threads()
    torch.set_num_threads(min(2, before))
    yield
    torch.set_num_threads(before)


def _b3():
    tree = b3_tests.jax_variables(JaxEfficientNet(**b3_tests.NARROW, dtype=jnp.float32))

    def port(dtype):
        return b3_tests.port_from_jax(tree, dtype)

    # 128 px: a 4 x 4 head map (32 px, its init size, leaves one pixel)
    return JaxEfficientNet(**b3_tests.NARROW, dtype=jnp.float32), tree, port, 128


def _fastervit(config):
    jmodel = JaxFasterViT(num_classes=2, num_heads=fv_tests._heads(config),
                          pos_mode="cpb" if config == "official" else "table",
                          dtype=jnp.float32, **fv_tests.NARROW)
    params, stats = init_model_variables(jmodel, jax.random.key(0),
                                         (1, fv_tests.SIZE, fv_tests.SIZE, 3))
    rng = np.random.default_rng(3)
    tree = {"params": fv_tests._perturbed(jax.device_get(params), rng),
            "batch_stats": fv_tests._perturbed(jax.device_get(stats), rng)}
    return jmodel, tree, lambda dtype: fv_tests._port_model(config, tree, dtype), fv_tests.SIZE


def _efficientformer():
    cfg, size = ef_tests.NARROW, 128
    tree = ef_tests.seeded_tree(cfg, size, np.random.default_rng(4))
    return (JaxEFv2(num_classes=2, dtype=jnp.float32, **cfg), tree,
            lambda dtype: ef_tests._port_model(cfg, size, tree, dtype), size)


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    if request.param == "b3":
        return _b3()
    if request.param == "efficientformerv2":
        return _efficientformer()
    return _fastervit(request.param.split("_")[1])


def _images(size, n=2, seed=5):
    return np.random.default_rng(seed).normal(size=(n, size, size, 3)).astype(np.float32)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_head_logits_are_the_models_logits(family, dtype):
    _, _, port, size = family
    model = port(dtype)
    x = torch.from_numpy(_images(size)).permute(0, 3, 1, 2)
    with torch.no_grad():
        feats = model.cam_features(x)
        want = model(x)
        got = head_logits(model, feats)
    assert feats.dtype == dtype and feats.dim() == 4 and feats.shape[0] == 2
    assert torch.equal(got, want)


@pytest.mark.parametrize("cls_idx", [0, 1])
def test_cam_matches_jax(family, cls_idx):
    jmodel, tree, port, size = family
    x = _images(size)
    with jax.default_matmul_precision("highest"):
        want = np.asarray(jax_compute_cam(jmodel, tree["params"], tree["batch_stats"],
                                          jnp.asarray(x), cls_idx))
    got = compute_cam(port(torch.float32), torch.from_numpy(x).permute(0, 3, 1, 2),
                      cls_idx).numpy()
    assert got.shape == want.shape == (2, size, size)
    # class 1's maps are live (class 0's may be ReLU'd to zero: every
    # weighted channel sum negative, as B3's are here)
    assert cls_idx == 0 or (float(want.max()) > 0.9 and float(want.min()) < 0.1)
    assert float(np.abs(got - want).max()) < CAM_GATE, float(np.abs(got - want).max())
    rgb = np.random.default_rng(6).random((size, size, 3)).astype(np.float32)
    diff = np.abs(show_cam_on_image(rgb, got[0]).astype(np.int16)
                  - jax_overlay(rgb, want[0]).astype(np.int16))
    assert diff.max() <= BYTE_GATE


def test_efficientformer_v2_cam_matches_the_hook_reference(monkeypatch):
    from deepfakedetection_tpu_torch.models.efficientformer_v2 import create_efficientformer_v2

    monkeypatch.setenv("DFD_EXACT_GELU", "1")  # the reference's nn.GELU is the erf form
    with torch.random.fork_rng():  # the reference's own init draws from the global generator
        torch.manual_seed(4)
        ref = _perturbed_ref(4)  # both classes' maps live in both images
    port = create_efficientformer_v2("s1", dtype=torch.float32).eval()
    port.load_state_dict(ref.state_dict())
    x = torch.randn(2, 3, 224, 224, generator=torch.Generator().manual_seed(10))
    for cls_idx in (0, 1):
        hook = TorchGradCAM(ref, ref.norm)
        want = hook(x, cls_idx)
        hook.remove()
        got = compute_cam(port, x, cls_idx).numpy()
        assert got.shape == want.shape == (2, 224, 224)
        assert float(want.reshape(2, -1).max(axis=1).min()) > 0.9
        assert float(np.abs(got - want).max()) < CAM_GATE, float(np.abs(got - want).max())
        rgb = np.random.default_rng(11).random((224, 224, 3)).astype(np.float32)
        diff = np.abs(show_cam_on_image(rgb, got[0]).astype(np.int16)
                      - ref_overlay(rgb, want[0]).astype(np.int16))
        assert diff.max() <= BYTE_GATE
