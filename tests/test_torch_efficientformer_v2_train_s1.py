"""The checks of ``tests/test_torch_efficientformer_v2_train.py`` on the
full-width EfficientFormerV2-S1 at 224 px, batch 2 (a file of its own, so
that the two JAX compilations run beside the narrow model's)."""

import pytest

from tests.test_torch_efficientformer_v2_train import (  # noqa: F401 (a fixture)
    _two_threads,
    check_gradients,
    check_running_statistics,
    check_train_step,
    make_case,
    make_port,
)


@pytest.fixture(scope="module")
def case():
    return make_case("s1")


@pytest.fixture(scope="module")
def port_f32(case):
    return make_port(case)


def test_s1_f32_train_forward_and_gradients_match_jax(case, port_f32):
    check_gradients(case, port_f32)


def test_s1_running_statistics_after_the_train_forward_match_jax(case, port_f32):
    check_running_statistics(case, port_f32)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_s1_train_step_matches_jax(case, dtype):
    check_train_step(case, dtype)
