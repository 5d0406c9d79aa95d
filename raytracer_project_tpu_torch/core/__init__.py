"""Core numerics: constants, vector math, SoA helpers, the lane RNG."""
