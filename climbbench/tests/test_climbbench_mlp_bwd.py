"""The two ``mlp_bwd_roofline.*`` readers on a trace made by hand: the
bound at the train cells' rows, the share from a time and a launch count,
and nothing without a launch; the kernel's name apart from the library's
and the FFN forward's, which other readers match."""

import pytest

from climbbench.common import HARNESS, Manifest
from climbbench.metrics import readers
from climbbench.tests.test_climbbench_counts import TRAIN, VILT, VILTBERT, event, reading
from climbbench.trace import Trace

KERNEL = "_anonymous_namespace_::mlp_bwd_bf16_wgmma_kernel_CUtensorMap_st__CUtensorMap_st"
METRICS = ("mlp_bwd_roofline.train", "mlp_bwd_roofline.viltbert")


def mlp_bwd_trace():
    """Two steps: a library GEMM at 10-30 us, the recompute kernel at 40-70
    and again at 80-90 (40 us in all), and the FFN forward at 92-95."""
    return Trace([
        event("user_annotation", "bench.window", 0, 100),
        event("user_annotation", "bench.step", 1, 45),
        event("user_annotation", "bench.step", 50, 45),
        event("kernel", "sm90_xmma_gemm_bf16", 10, 20, tid=7),
        event("kernel", KERNEL, 40, 30, tid=7),
        event("kernel", KERNEL, 80, 10, tid=7),
        event("kernel", "linear_bf16_wgmma_kernel", 92, 3, tid=7),
    ], steps=2)


@pytest.mark.parametrize("metric", METRICS)
def test_bound_at_the_train_cells_rows(metric):
    bound_s = Manifest(HARNESS.parent).reader(metric).bound_s
    assert 64 * 281 == 17984
    assert round(bound_s(17984, 768, 3072) * 1e3, 4) == 0.1716
    # operations-bound there: 169.7 GFLOP against 115 MB
    assert bound_s(17984, 768, 3072) == pytest.approx(4 * 17984 * 768 * 3072 / 989e12)


@pytest.mark.parametrize("metric, config", [(METRICS[0], VILT), (METRICS[1], VILTBERT)])
def test_share_from_the_traced_time_and_the_calls(metric, config):
    reader = Manifest(HARNESS.parent).reader(metric)
    r = reading(mlp_bwd_trace(), {"mlp_bwd": 4, "mlp_fwd": 2}, config=config, traffic=TRAIN)
    bound = reader.bound_s(64 * 281, 768, 3072)
    assert reader.read(r) == pytest.approx(100 * bound / (40e-6 / 4))
    # the library GEMM and the FFN forward are not counted as the recompute
    assert readers.library_gemm_ms(r) == pytest.approx(1e3 * 20e-6 / 2)


@pytest.mark.parametrize("metric", METRICS)
def test_nothing_to_read_without_a_launch_or_a_trace(metric):
    reader = Manifest(HARNESS.parent).reader(metric)
    assert reader.read(reading(mlp_bwd_trace(), {"mlp_fwd": 2})) is None
    assert reader.read(reading(mlp_bwd_trace(), {"mlp_bwd": 0})) is None
    assert reader.read(reading(None, {"mlp_bwd": 4})) is None


@pytest.mark.parametrize("metric", METRICS)
def test_kernel_name_is_apart_from_the_other_readers(metric):
    reader = Manifest(HARNESS.parent).reader(metric)
    for name in reader.KERNELS + (KERNEL,):
        assert not readers.LIBRARY.search(name)
        assert not any(k in name for k in readers.FFN_KERNELS)
