"""Core numeric constants (twin of raytracer_project_tpu/core/constants.py).

Everything the kernels see is float32; the values are the reference
engine's (common.hpp, camera.hpp).
"""

import numpy as np

PI = float(np.pi)

# Self-intersection offset applied when respawning scattered rays.
RAY_EPSILON = 1e-4

# Minimum hit distance for primary/secondary rays.
T_MIN = 1e-3

# Large-but-finite stand-in for +inf ray extents.
T_MAX = 1e30

# Weak-ray early-out threshold.
WEAK_RAY_EPS = 1e-4

# Russian roulette starts strictly after this bounce index.
RR_START_BOUNCE = 10
RR_P_MIN = 0.05
RR_P_MAX = 0.95

# Default z-depth normalization distance.
Z_DEPTH_MAX_DIST = 50.0


def degrees_to_radians(deg):
    return deg * PI / 180.0

