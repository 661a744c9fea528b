"""The port's eval job on B3 with ``DFD_FUSED_MBCONV`` set: the model reads
the switch when the job builds it, so ``orchestrate(mode="inference")``
reaches K3 with no change to the job. The narrow B3 at 32 px and its ``.pth``
are tests/test_torch_eval_job.py's (a JAX init exported to torch, with a
fitted classifier); the job runs in bf16 on the CPU (K3's plain version)
against the same job without the switch. Gates: K3 three times a forward
batch (the narrow model's three residual blocks with an expansion),
probabilities within 2e-2 (the bf16 gate of tests/test_torch_eval_job.py),
the swept threshold within 2e-2 and the same decisions away from it.
Measured max|dp|: 1.7e-3 test, 3.8e-3 val; the same threshold.
"""

import numpy as np
import pytest

import deepfakedetection_tpu_torch.orchestrator as port_orch
from deepfakedetection_tpu_torch.models import efficientnet
from tests.test_torch_eval_job import _config, _port_spec, checkpoint  # noqa: F401

BATCHES = 4  # val and test: 12 images each at batch 8


@pytest.fixture(scope="module")
def jobs(tiny_image_tree, checkpoint, tmp_path_factory):  # noqa: F811
    tmp = tmp_path_factory.mktemp("fused_mbconv_job")
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(port_orch, "get_model_spec", lambda name: _port_spec())
        calls = {"k3": 0}
        real = efficientnet.fused_mbconv_se

        def counting(*args, **kwargs):
            calls["k3"] += 1
            return real(*args, **kwargs)

        mp.setattr(efficientnet, "fused_mbconv_se", counting)
        out = {}
        for name in ("off", "on"):
            if name == "on":
                mp.setenv("DFD_FUSED_MBCONV", "1")
            else:
                mp.delenv("DFD_FUSED_MBCONV", raising=False)
            calls["k3"] = 0
            cfg = _config(tmp / f"{name}.yaml", tiny_image_tree, tmp / name, checkpoint,
                          "bfloat16")
            res = port_orch.orchestrate(cfg, mode="inference")["efficientnet_b3"]
            out[name] = (res, calls["k3"])
        return out
    finally:
        mp.undo()


def test_eval_job_reaches_k3_three_times_a_batch(jobs):
    assert jobs["off"][1] == 0
    assert jobs["on"][1] == 3 * BATCHES


def test_eval_job_with_k3_decides_as_without_it(jobs):
    off, on = jobs["off"][0], jobs["on"][0]
    assert on.probs.shape == off.probs.shape == (12, 2)
    np.testing.assert_array_equal(on.targets, off.targets)
    np.testing.assert_allclose(on.probs, off.probs, atol=2e-2, rtol=0)
    np.testing.assert_allclose(on.val_probs, off.val_probs, atol=2e-2, rtol=0)
    t_off, t_on = off.metrics["threshold"], on.metrics["threshold"]
    assert abs(t_on - t_off) <= 2e-2
    p = off.probs[:, 1]
    far = (np.abs(p - t_off) > 2e-2) & (np.abs(p - t_on) > 2e-2)
    assert far.sum() >= 6
    np.testing.assert_array_equal(on.preds[far], off.preds[far])
