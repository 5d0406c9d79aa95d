"""The benchmark's plain reference: what decides a run's `correct`.

`tracer/` is a frozen copy of the plain PyTorch versions of the port
(raytracer_project_tpu_torch) as of the benchmark's first commit: the scene
builder and its tables, the camera, the environment, the RNG, and the plain
closest hit (K1), decode (K2) and shade-advance (K3) of the fused pool.
The port's CPU tests hold those plain versions against the JAX package to
the ulp, so the copy is the reference's arithmetic; it imports nothing of
the port and takes nothing the port has made. `render.reference_sums`
builds its own tables from the configuration's generator and traces the
sampled pixels' paths without a pool (every (pixel, sample) lane from its
camera ray until it finishes), so a pixel's sum is the per-sample
semantics the port's pool must reproduce.
"""
