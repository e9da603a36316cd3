"""The frozen yardstick reproduces the kernel table's bounds, and the trace
reduction's interval arithmetic."""

import bench_tiny  # noqa: F401  (paths)
import pytest

import roofline
from tracing import Trace, gaps, kernel_name, union_length


def ms(flops_bytes):
    return roofline.bound_s(*flops_bytes) * 1e3


def test_k1_bound_at_b1_t512():
    assert ms(roofline.k1(1, 512)) == pytest.approx(0.200, abs=5e-4)


def test_resblock_five_stages_at_t_mel_512():
    stages = [(256, 4096), (128, 32768), (64, 65536), (32, 131072), (16, 262144)]
    flops = sum(roofline.resblock_stage(1, t, c)[0] for c, t in stages)
    nbytes = sum(roofline.resblock_stage(1, t, c)[1] for c, t in stages)
    assert roofline.bound_s(flops, nbytes) * 1e3 == pytest.approx(4.796, abs=5e-4)


@pytest.mark.parametrize("fn, want", [(roofline.k5_save, 9.616), (roofline.k5_chain, 7.692)])
def test_k5_bounds_at_b16_t1536(fn, want):
    assert ms(fn(16, 1536)) == pytest.approx(want, abs=5e-4)


def test_vocoder_flops_count_the_resblock_stages():
    h = {"num_mels": 128, "upsample_initial_channel": 512, "upsample_rates": [8, 8, 2, 2, 2],
         "upsample_kernel_sizes": [16, 16, 4, 4, 4], "resblock_kernel_sizes": [3, 7, 11],
         "resblock_dilation_sizes": [[1, 3, 5]] * 3}
    stages = [(256, 8), (128, 64), (64, 128), (32, 256), (16, 512)]
    res = sum(2 * 126 * c * c * per for c, per in stages)
    total = roofline.vocoder_flops(1, h)
    assert res < total < 1.05 * res


def test_union_gaps_and_names():
    iv = [(0, 2), (1, 3), (5, 6)]
    assert union_length(iv) == 4
    assert gaps(iv, 0, 8) == [(3, 5), (6, 8)]
    assert kernel_name("void conv_kernel<128, 64, 4, 3, true>(float const*, int)") == "conv_kernel"
    assert kernel_name("Memcpy HtoD (Pinned -> Device)") == "Memcpy HtoD (Pinned -> Device)"
    tr = Trace([("chain_kernel(float*)", 0, 2e6, 0), ("x(int)", 3e6, 4e6, 0)],
               [("vocode", 1e6, 5e6), ("prepare", 2.2e6, 3e6)], 0, 5e6)
    assert tr.busy_s == 3.0 and tr.window_s == 5.0
    assert tr.kernel_s({"chain_kernel"}) == 2.0 and tr.kernel_s({"absent"}) is None
    assert dict(tr.idle_by_span()) == {"prepare": 1.0, "vocode": 1.0}


def test_busy_and_idle_are_averaged_over_the_devices():
    """Two devices, one busy 4 of 5 s and one 2 of 5 s; a third asked for
    that ran nothing counts as idle."""
    ops = [("a(int)", 0, 4e6, 0), ("a(int)", 1e6, 3e6, 1)]
    spans = [("step", 0, 5e6)]
    two = Trace(ops, spans, 0, 5e6, n_devices=2)
    assert two.busy_s == 3.0 and two.kernel_s({"a"}) == 6.0 and two.n_ops == 2
    assert dict(two.idle_by_span()) == {"step": 2.0}
    three = Trace(ops, spans, 0, 5e6, n_devices=3)
    assert three.busy_s == 2.0
    assert dict(three.idle_by_span()) == {"step": 3.0}
