"""Several processes rendering one frame (twin of
raytracer_project_tpu/parallel/distributed.py) on torch.distributed.

Every process runs the same program: `init_distributed` joins the process
group, `make_global_mesh` lists one window per process, each process
renders its window and `gather_to_host0` brings the windows to every
process as host numpy (rank 0 writes the image); `render_distributed`
does all of that. Image statistics reduce with
post.analyze_framebuffer_psum over the group.

Environment (the reference's variables):
  COORDINATOR_ADDRESS  host:port of process 0 (required for > 1 process)
  NUM_PROCESSES        the number of processes
  PROCESS_ID           this process's rank
`init_distributed` is a no-op for one process, so every entry point can
call it. The group's backend is gloo: tensors cross processes through
host memory, whatever device renders.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     init_method: str | None = None) -> bool:
    """Join the gloo process group (idempotent). The arguments default to
    the environment variables above; init_method (e.g. "file://...")
    replaces tcp://COORDINATOR_ADDRESS. Returns True when running with
    more than one process, False for one process (no group is made)."""
    coordinator_address = coordinator_address or os.environ.get(
        "COORDINATOR_ADDRESS")
    if num_processes is None:
        num_processes = int(os.environ.get("NUM_PROCESSES", "1"))
    if process_id is None:
        process_id = int(os.environ.get("PROCESS_ID", "0"))
    if num_processes <= 1 or (coordinator_address is None
                              and init_method is None):
        return False
    if dist.is_initialized():
        return True
    dist.init_process_group(
        "gloo", init_method=init_method or f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)
    return True


def _world() -> tuple[int, int]:
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def make_global_mesh(device=None) -> list:
    """One entry per process of the group, each naming the device the
    process renders on (`device`, by default cuda when present else the
    CPU): a mesh for parallel/render.py whose i-th window is rank i's."""
    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    return [torch.device(device)] * _world()[1]


def local_shard(global_ids: np.ndarray, mesh) -> np.ndarray:
    """The ids of `global_ids` that this process renders: the slice of its
    rank (the mesh has one entry per process)."""
    per = -(-global_ids.shape[0] // len(mesh))
    rank = _world()[0]
    return global_ids[rank * per:(rank + 1) * per]


def gather_to_host0(tensor) -> np.ndarray:
    """The windows of all processes, concatenated in rank order, as host
    numpy on every process (only rank 0's copy is meant to be used).
    Every process's window has the same shape."""
    local = torch.as_tensor(tensor).detach().cpu()
    world = _world()[1]
    if world == 1:
        return local.numpy()
    parts = [torch.empty_like(local) for _ in range(world)]
    dist.all_gather(parts, local.contiguous())
    return torch.cat(parts).numpy()


def is_host0() -> bool:
    return _world()[0] == 0


def render_distributed(scene, cam, env, seed: int, config, device=None) -> dict:
    """This process renders its pixel window of the frame (one window per
    process, parallel/render.py's padding) on `device`, and every process
    gets the whole frame's averaged buffers as host numpy [H, W, 3]."""
    from ..ops import integrator
    from .render import _padded_pixel_ids

    mesh = make_global_mesh(device)
    dev = mesh[0]
    n = config.n_pixels
    n_local = _padded_pixel_ids(n, len(mesh)).shape[0] // len(mesh)
    acc = integrator.accumulate_samples(
        scene.to(dev), cam.to(dev), env.to(dev), seed, config,
        pixel_offset=_world()[0] * n_local, n_pixels_local=n_local)
    full = integrator.SampleBuffers(*(
        torch.as_tensor(gather_to_host0(x))[:n] for x in acc))
    return {k: v.numpy() for k, v in
            integrator.finalize_buffers(full, config).items()}
