"""The rule a profiler trace is held to (``timing._verdict``) and the
marker schedule of its retries, on stand-in events: the traces
themselves need a card."""

from types import SimpleNamespace

import pytest

from paddle_tpu_torch.benchmarks import timing

GEMM = "sm90_xmma_gemm_f32f32_f32f32_f32_nn_n_kernel"
ADD = ("void at::native::vectorized_elementwise_kernel<4, "
       "at::native::CUDAFunctor_add<float> >")
SEED = ("void at::native::vectorized_elementwise_kernel<2, "
        "at::native::FillFunctor<long>, std::array<char*, 1ul> >")


def _events(counts):
    return [SimpleNamespace(key=k, count=n) for k, n in counts.items()]


@pytest.mark.parametrize("counts, iters, expect, replay, bad", [
    ({GEMM: 4, ADD: 8}, 2, None, False, {}),
    ({GEMM: 3, ADD: 8}, 2, None, False, {GEMM: 3}),
    # a copy, a cuDNN layout conversion and a one-element int64 kernel may
    # miss the multiple
    ({GEMM: 4, "Memcpy HtoD (Pageable -> Device)": 3,
      "nchwToNhwcKernel": 5, SEED: 3}, 2, None, False, {}),
    ({GEMM: 4, ADD: 8}, 2, {"xmma_gemm": 3}, False, {"xmma_gemm": 4}),
    ({GEMM: 6}, 2, {("xmma_gemm", "nvjet"): 3}, False, {}),
    # a replay trace may be one launch short of one kernel, no more
    ({GEMM: 3, ADD: 8}, 2, None, True, {}),
    ({GEMM: 3, ADD: 7}, 2, None, True, {GEMM: 3, ADD: 7}),
    ({GEMM: 8, ADD: 18}, 4, None, True, {ADD: 18}),
])
def test_verdict_holds_a_trace_to_the_launches(counts, iters, expect,
                                                replay, bad):
    got, short, int64 = timing._verdict(_events(counts), iters, expect,
                                        replay)
    assert got == bad
    if replay and not bad and counts[GEMM] % iters:
        assert short == GEMM
    else:
        assert short is None
    assert int64 == ({SEED: 3} if SEED in counts else {})


def test_retries_spin_longer_markers():
    ms = [timing._MARKER_MS[min(a, len(timing._MARKER_MS) - 1)]
          for a in range(6)]
    assert ms == [10, 20, 40, 80, 80, 80]
    assert all(b >= a for a, b in zip(ms, ms[1:]))
    assert timing._CYCLES_PER_MS * ms[0] // 8 > 1000
