"""Faults planted under the timed path, for the tests that show the check
catches them (benchmark/tests/test_bench_check.py). A run applies none; a test
passes one to harness.run_cell, which applies it in every rank's process
and takes it out when the run ends.

  state_unchanged     an update returns the sums unchanged (adds nothing)
  half_batch          an update renders half its samples and scales their
                      sums up to the whole: the mean over the rest
  exchange_left_out   the gather between ranks returns this rank's part in
                      every rank's place
  answer_altered      K3 alters each finished path's radiance by 1% where
                      it is produced (its plain version, on the CPU)
  jax_in_a_rank       every rank but 0 (a spawned process) holds a module
                      named raytracer_project_tpu, the JAX package's name
"""

from __future__ import annotations


def apply(name: str):
    """Plant fault `name`; returns a function that takes it out again."""
    import torch

    from raytracer_project_tpu_torch.ops import fused_step, integrator
    from raytracer_project_tpu_torch.parallel import distributed

    if name in ("state_unchanged", "half_batch"):
        inner = integrator.accumulate_samples

        def faulty(scene, cam, env, seed, config, *args, **kw):
            import dataclasses

            spp = config.samples_per_pixel
            if name == "half_batch" and spp > 1:
                half = dataclasses.replace(config, samples_per_pixel=spp // 2)
                out = inner(scene, cam, env, seed, half, *args, **kw)
                scale = spp / (spp // 2)
                bufs, stats = out if isinstance(out, tuple) else (out, None)
                bufs = type(bufs)(*(x * scale for x in bufs))
                return (bufs, stats) if stats is not None else bufs
            out = inner(scene, cam, env, seed, config, *args, **kw)
            bufs, stats = out if isinstance(out, tuple) else (out, None)
            bufs = type(bufs)(*(torch.zeros_like(x) for x in bufs))
            return (bufs, stats) if stats is not None else bufs

        integrator.accumulate_samples = faulty
        return lambda: setattr(integrator, "accumulate_samples", inner)
    elif name == "exchange_left_out":
        def no_exchange(tensor):
            world = distributed._world()[1]
            return torch.cat([tensor] * world)

        inner = distributed.all_gather
        distributed.all_gather = no_exchange
        return lambda: setattr(distributed, "all_gather", inner)
    elif name == "answer_altered":
        inner = fused_step.shade_advance_plain

        def altered(*args, **kw):
            out = list(inner(*args, **kw))
            out[2] = out[2] * 1.01      # contrib rows
            return tuple(out)

        fused_step.shade_advance_plain = altered
        return lambda: setattr(fused_step, "shade_advance_plain", inner)
    elif name == "jax_in_a_rank":
        import multiprocessing
        import sys
        import types

        if multiprocessing.parent_process() is None:
            return lambda: None
        sys.modules["raytracer_project_tpu"] = types.ModuleType(
            "raytracer_project_tpu")
        return lambda: sys.modules.pop("raytracer_project_tpu", None)
    else:
        raise ValueError(f"no fault {name!r}")
