"""The yardstick: the bound arithmetic gives the kernel table's bounds, and
the benchmark's own ResNet-50 shapes give its published size."""

import pytest

from portbench.reference import bounds, resnet50


def test_the_bench_points_bound_by_operations():
    ms, by = bounds.bound(0, 2 * 4096 * 1_000_000 * 128, bounds.BF16_FLOPS)
    assert by == "operations" and ms == pytest.approx(1.0602, abs=5e-5)
    assert bounds.search_bound_ms(4096, 1_000_000, 128, 10, 2) == pytest.approx(1.0602, abs=5e-5)


def test_the_f32_scan_bounds_by_bytes():
    ms, by = bounds.kernel_bounds(1, 1_000_000, 2048, 4, 7813, 24, 24 * 128, False)["groupmin"]
    assert by == "bytes" and ms == pytest.approx(2.4466, abs=5e-5)


def test_resnet50_shapes():
    assert resnet50.macs_per_image(224) == pytest.approx(4.09e9, rel=0.01)
    params = sum(s[0] * (s[1] if len(s) > 1 else 1) * (s[2] * s[3] if len(s) == 4 else 1)
                 for _, s, kind in resnet50.param_shapes() if kind == "conv")
    assert params == pytest.approx(23.45e6, rel=0.01)  # torchvision's 25.56M less fc and norms
    assert len(resnet50.convs()) == 53
