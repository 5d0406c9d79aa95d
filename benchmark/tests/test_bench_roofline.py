"""The roofline byte counts against a count by hand at a tiny size."""

import pytest

from benchmark import roofline


def test_k1_bytes_by_hand():
    # 10 live lanes: 6 f32 of ray in, t + index + type out = 36 B each;
    # 3 launches, each reading 2 spheres (4 f32), 1 triangle (9 f32) and
    # 1 box (12 f32): 32 + 36 + 48 = 116 B.
    assert roofline.k1_bytes(10, 3, (2, 1, 1)) == 10 * 36 + 3 * 116


def test_k3_bytes_by_hand():
    # 10 live lanes: hit 12 B in, 16 words of path state in and out (128 B);
    # 4 finished paths, 12 B each; 3 launches of 116 B of geometry, 5
    # materials of 5 words and 1 volume of 16 words.
    per_launch = 116 + 5 * 20 + 64
    assert roofline.k3_bytes(10, 4, 3, (2, 1, 1), 5, 1) == (
        10 * 140 + 4 * 12 + 3 * per_launch)


def test_bound_is_bytes_over_hbm_bandwidth():
    assert roofline.bound_seconds(3.35e12) == pytest.approx(1.0)
