"""Several processes rendering one frame (twin of
raytracer_project_tpu/parallel/distributed.py) on torch.distributed.

Every process runs the same program: `init_distributed` joins the process
group, `local_devices` names the cards this process renders on (one per
rank by default, or several), `make_global_mesh` gathers every process's
devices into one mesh with each entry's owner rank, each process renders
the windows it owns at once (parallel/render.sharded_accumulate), and
`gather_to_host0` brings the windows to every process (rank 0 writes the
image); `render_distributed` does all of that. Image statistics reduce
with post.analyze_framebuffer_psum over the group.

A group whose processes render on CUDA runs on NCCL: windows are gathered
and statistics reduced on the cards, and the frame crosses to the host
once, at the end. A group rendering on the CPU runs on gloo, which is
also what two ranks sharing one card must use (NCCL refuses two ranks on
one device).

Environment. Each value is taken from the argument when one is given,
else from the reference's variables, else from torchrun's:
  COORDINATOR_ADDRESS  host:port of process 0   (torchrun: MASTER_ADDR and
                                                 MASTER_PORT)
  NUM_PROCESSES        the number of processes  (torchrun: WORLD_SIZE)
  PROCESS_ID           this process's rank      (torchrun: RANK)
  LOCAL_RANK           this process's index on its node (torchrun's; else
                       its rank, as for processes of one node)
`init_distributed` is a no-op for one process, so every entry point can
call it.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np
import torch
import torch.distributed as dist

from ..utils import spans


def _env_int(*names, default: int) -> int:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return default


def _coordinator() -> str | None:
    if os.environ.get("COORDINATOR_ADDRESS"):
        return os.environ["COORDINATOR_ADDRESS"]
    if os.environ.get("MASTER_ADDR") and os.environ.get("MASTER_PORT"):
        return f"{os.environ['MASTER_ADDR']}:{os.environ['MASTER_PORT']}"
    return None


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None,
                     init_method: str | None = None,
                     backend: str | None = None,
                     device=None) -> bool:
    """Join the process group (idempotent). The first three arguments
    default to the environment (see the module's docstring); init_method
    (e.g. "file://...") replaces tcp://<coordinator>. backend defaults to
    "nccl" when this process renders on CUDA and "gloo" on the CPU:
    `device` is where it renders, None meaning the card (raises without
    one, as every entry point). Returns True when running with more than
    one process, False for one process (no group is made)."""
    coordinator_address = coordinator_address or _coordinator()
    if num_processes is None:
        num_processes = _env_int("NUM_PROCESSES", "WORLD_SIZE", default=1)
    if process_id is None:
        process_id = _env_int("PROCESS_ID", "RANK", default=0)
    if num_processes <= 1 or (coordinator_address is None
                              and init_method is None):
        return False
    if dist.is_initialized():
        return True
    if backend is None:
        from ..ops.integrator import resolve_device

        backend = "nccl" if resolve_device(device).type == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method=init_method or f"tcp://{coordinator_address}",
        world_size=num_processes, rank=process_id)
    return True


def _world() -> tuple[int, int]:
    if dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def _local_rank() -> int:
    return _env_int("LOCAL_RANK", default=_world()[0])


def local_devices(device=None, per_process: int = 1) -> list:
    """The devices this process renders on, one window each. By default
    (device None or a bare "cuda") the per_process consecutive cards from
    LOCAL_RANK * per_process; raises without CUDA, or when the node has too
    few cards. A device with an index, or "cpu", is repeated per_process
    times: ranks that share one card (under gloo), or the CPU for tests."""
    from ..ops.integrator import resolve_device

    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return [dev] * per_process
    first = _local_rank() * per_process
    count = torch.cuda.device_count()
    if first + per_process > count:
        raise RuntimeError(
            f"local rank {_local_rank()} renders on cards {first}.."
            f"{first + per_process - 1}, and the node has {count}")
    return [torch.device("cuda", first + k) for k in range(per_process)]


def make_global_mesh(local) -> tuple[list, list]:
    """(mesh, owners): every process's `local` devices (local_devices) in
    rank order, and owners[i] the rank that renders window i. Without a
    group, `local` itself, owned by rank 0. Every process must name as many
    devices: the windows of the frame are of one size."""
    local = [torch.device(d) for d in local]
    if not dist.is_initialized():
        return local, [0] * len(local)
    parts = [None] * dist.get_world_size()
    with _collective_device(local[0]):
        dist.all_gather_object(parts, [str(d) for d in local])
    if len({len(p) for p in parts}) != 1:
        raise ValueError(f"the processes name unequal numbers of devices: "
                         f"{[len(p) for p in parts]}")
    mesh = [torch.device(d) for p in parts for d in p]
    owners = [r for r, p in enumerate(parts) for _ in p]
    return mesh, owners


def _collective_device(dev):
    """NCCL's object collectives run on the current card: make it `dev`."""
    if dev.type == "cuda" and dist.get_backend() == "nccl":
        return torch.cuda.device(dev)
    return contextlib.nullcontext()


def my_windows(owners) -> list:
    """The indices of the windows this process renders."""
    rank = _world()[0]
    return [i for i, o in enumerate(owners) if o == rank]


def local_shard(global_ids: np.ndarray, owners) -> np.ndarray:
    """The ids of `global_ids` that this process renders: the slices of the
    windows it owns (make_global_mesh's owners; one window per entry)."""
    per = -(-global_ids.shape[0] // len(owners))
    mine = [global_ids[i * per:(i + 1) * per] for i in my_windows(owners)]
    return np.concatenate(mine) if mine else global_ids[:0]


def all_gather(tensor) -> torch.Tensor:
    """Every process's `tensor` (of one shape on all), concatenated along
    dim 0 in rank order: on the tensor's card under NCCL, on the host under
    gloo; the tensor itself without a group."""
    if not dist.is_initialized():
        return tensor
    if dist.get_backend() != "nccl":
        tensor = tensor.cpu()
    tensor = tensor.contiguous()
    parts = [torch.empty_like(tensor) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, tensor)
    return torch.cat(parts)


def gather_to_host0(tensor) -> np.ndarray:
    """The windows of all processes, concatenated in rank order, as host
    numpy on every process (only rank 0's copy is meant to be used):
    gathered on the cards under NCCL, through the host under gloo."""
    return all_gather(torch.as_tensor(tensor).detach()).cpu().numpy()


def is_host0() -> bool:
    return _world()[0] == 0


def render_distributed(scene, cam, env, seed: int, config, device=None,
                       per_process: int = 1) -> dict:
    """This process renders its windows of the frame (local_devices(device,
    per_process), all at once), and every process gets the whole frame's
    averaged buffers as host numpy [H, W, 3]: under NCCL the windows are
    gathered and averaged on the card and copied to the host once."""
    from ..ops import integrator
    from . import render as prender

    with spans.span("dist.frame"):
        with spans.span("dist.mesh"):
            mesh, owners = make_global_mesh(local_devices(device,
                                                          per_process))
        n = config.n_pixels
        ids = prender._padded_pixel_ids(n, len(mesh))
        with spans.span("dist.render"):
            acc = prender.sharded_accumulate(
                scene, cam, env, seed, config, ids, 0, mesh=mesh,
                windows=my_windows(owners))
        with spans.span("dist.gather"):
            # One gather of the six buffers, [rows, 6, 3].
            full = all_gather(torch.stack(list(acc), dim=1))[:n]
        with spans.span("dist.finalize"):
            out = integrator.finalize_buffers(
                integrator.SampleBuffers(*full.unbind(1)), config)
        with spans.span("dist.copy"):
            host = torch.stack(list(out.values())).cpu().numpy()
        return dict(zip(out, host))
