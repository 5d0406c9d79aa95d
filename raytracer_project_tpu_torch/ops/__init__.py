"""Rendering operations: intersection, the fused pool step, the integrator."""
