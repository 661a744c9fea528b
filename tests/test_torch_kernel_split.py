"""``chip_smoke.kernel_split``'s decision over the profiler's records, on the
CPU, with fabricated ``(key, count, device_time_total in us)`` records in
place of ``torch.profiler``'s: a call with no device kernel or no device
time, or without a kernel it was expected to launch, is profiled once more
(over three times the calls) and raises if the second take is no better; a
normal call passes on the first take, and a good retake gives the time a
call.
"""

import pytest

import chip_smoke as cs
from deepfakedetection_tpu_torch.ops import window_attn as k5

CALLS = 10
K5_BWD = [
    ("void (anonymous namespace)::window_attention_bwd_kernel<4, 4>(View, View, View, View, "
     "float const*, __nv_bfloat16*, long long, long long, float*, int, int, int, int, int, int, "
     "int, float, int)", CALLS, 1834.0),
    ("(anonymous namespace)::dbias_reduce_kernel(float const*, float*, int, long long, long long)",
     CALLS, 41.0),
    ("cudaLaunchKernel", 2 * CALLS, 0.0),
]


class Takes:
    """A stand-in for the profiler: each call returns the next record list,
    its counts scaled to the calls asked for (the retake spans three times
    the first take's)."""

    def __init__(self, *takes):
        self.takes, self.calls = list(takes), []

    @property
    def count(self):
        return len(self.calls)

    def __call__(self, fn, calls):
        assert calls == CALLS * (3 if self.calls else 1)
        self.calls.append(calls)
        return [(key, n * calls // CALLS, us * calls / CALLS) for key, n, us in self.takes.pop(0)]


def split(take, expect=k5.BWD_KERNELS):
    return cs.kernel_split(lambda: None, calls=CALLS, expect=expect, take=take, pause=0.0)


def test_a_normal_call_passes_on_the_first_take():
    take = Takes(K5_BWD)
    got, launched = split(take)
    assert got == pytest.approx({"window_attention_bwd_kernel": 0.1834,
                                 "dbias_reduce_kernel": 0.0041})
    assert launched == 2 and take.count == 1


@pytest.mark.parametrize("records", [[], [("cudaLaunchKernel", CALLS, 0.0)],
                                     [(key, n, 0.0) for key, n, _ in K5_BWD]],
                         ids=["empty", "no kernel", "zero device time"])
@pytest.mark.parametrize("expect", [(), k5.BWD_KERNELS], ids=["library", "port"])
def test_no_device_time_raises_after_the_retake(records, expect):
    take = Takes(records, records)
    with pytest.raises(cs.DeviceTimeMissing, match="no device time"):
        split(take, expect)
    assert take.calls == [CALLS, 3 * CALLS]


@pytest.mark.parametrize("present", [K5_BWD[1:], K5_BWD[:1] + K5_BWD[2:]],
                         ids=["no window kernel", "no reduction"])
def test_a_missing_expected_kernel_raises_after_the_retake(present):
    take = Takes(present, present)
    with pytest.raises(cs.DeviceTimeMissing, match="expected kernels"):
        split(take)
    assert take.calls == [CALLS, 3 * CALLS]


def test_a_retake_with_device_time_passes():
    take = Takes([], K5_BWD)
    got, launched = split(take)
    assert sum(got.values()) == pytest.approx(0.1875) and launched == 2
    assert take.calls == [CALLS, 3 * CALLS]


def test_library_yardsticks_need_only_some_device_time():
    """A library call's kernels are not named in advance; nor is its device
    time held to its event time (host-bound by nature)."""
    records = [("void cutlass::Kernel<fmha_cutlassB_bf16_aligned>(Params)", CALLS, 50.0),
               ("aten::mm", CALLS, 0.0)]
    got, launched = cs.split_records(records, CALLS)
    assert got == pytest.approx({"void cutlass::Kernel<fmha_cutlassB_bf16_aligned>(Params)":
                                 0.005}) and launched == 1


def test_k6_gemm_is_named_by_its_epilogue():
    records = [("void (anonymous namespace)::gemm_kernel<128, (anonymous namespace)::DctxEpi>("
                "Args)", CALLS, 300.0),
               ("(anonymous namespace)::window_bwd_kernel<48>(Args)", CALLS, 900.0),
               ("(anonymous namespace)::sum_partials_kernel(SumJob)", CALLS, 30.0)]
    got, _ = cs.split_records(records, CALLS, cs.K6_BWD_KERNELS)
    assert set(got) == {"gemm_kernel<DctxEpi>", "window_bwd_kernel", "sum_partials_kernel"}
