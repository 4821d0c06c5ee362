"""The kernels' work counted from shapes, pinned at the rim partition."""

import pytest

from pgobench import roofline

H100 = "NVIDIA H100 80GB HBM3"


def test_partition():
    assert roofline.partition(10_240, 16) == (640, 640)
    assert roofline.partition(10_195, 16) == (638, 637)
    assert roofline.partition(102_400, 16) == (6_400, 6_400)
    assert roofline.partition(10_000, 16) == (625, 625)
    assert roofline.partition(10, 4) == (3, 2)


def test_stpcg_at_rim():
    w = roofline.stpcg_work(16, 640, 3)
    # Hred and P [16, 1920, 1920] float32, each read once: 471.9 MB.
    assert w["operator_bytes"] == 471_859_200
    assert w["operator_bytes"] / 3.35e12 == pytest.approx(0.1409e-3,
                                                          abs=5e-8)
    # Six [16, 1920, 3] vectors and 13 bytes per node beside them.
    assert w["bytes"] == 471_859_200 + 6 * 368_640 + 16 * 13
    assert roofline.bound_s(w, H100) == pytest.approx(0.14151e-3, abs=5e-9)
    # Bytes bind: one CG iteration's operations take 10.6 us at 67 TFLOP/s.
    assert w["flops"] / 67e12 < w["bytes"] / 3.35e12


def test_stpcg_at_rim_g2o_counts():
    """rim3d_10k_16n: 10,195 poses over 16 nodes, padded to 638 each."""
    w = roofline.stpcg_work(16, 638, 3)
    # Hred and P [16, 1914, 1914] float32, each read once: 468.9 MB.
    assert w["operator_bytes"] == 468_914_688
    assert w["bytes"] == 468_914_688 + 6 * 16 * 1914 * 3 * 4 + 16 * 13
    assert roofline.bound_s(w, H100) == pytest.approx(0.14063e-3, abs=5e-9)


def test_polar_so3_at_rim():
    w = roofline.polar_so3_work(10_240)
    assert w["bytes"] == 737_280
    assert roofline.bound_s(w, H100) == pytest.approx(0.00022e-3, abs=5e-10)
    # rim3d_10k_16n: 16 nodes padded to 638 poses.
    assert roofline.polar_so3_work(16 * 638)["bytes"] == 734_976


def test_unknown_card_has_no_bound():
    assert roofline.bound_s(roofline.polar_so3_work(8), "cpu") is None
