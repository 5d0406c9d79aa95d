"""Frozen copy of raytracer_project_tpu_torch/core/constants.py (plain
PyTorch parts only), for the benchmark's reference; see
benchmark/reference/__init__.py."""

import numpy as np


PI = float(np.pi)


RAY_EPSILON = 1e-4


T_MIN = 1e-3


T_MAX = 1e30


WEAK_RAY_EPS = 1e-4


RR_START_BOUNCE = 10


RR_P_MIN = 0.05


RR_P_MAX = 0.95


Z_DEPTH_MAX_DIST = 50.0


def degrees_to_radians(deg):
    return deg * PI / 180.0

