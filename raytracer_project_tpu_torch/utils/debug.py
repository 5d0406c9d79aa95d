"""Numerical debugging aids: NaN trapping and buffer audits (twin of
raytracer_project_tpu/utils/debug.py).

The reference engine relies on scrub-and-continue guards (NaN scrubbed
before ACES and OIDN, common.hpp:50-55, camera.hpp:601-606) and has no
detector. The reference package adds checkify float traps; the port's
counterpart is a TorchDispatchMode that looks at the output of every aten
op and raises on the first floating output that holds a NaN, naming the
op. Like checkify it flags a NaN that a later `where` would mask.

The trap sees aten ops only: what a CUDA kernel writes through a raw
pointer (csrc/*.cu) is invisible to it. So a checked run is a run of the
kernels' plain versions, which is what a render on the CPU is; the caller
picks that device, as the CLI's --check-numerics does.
"""

from __future__ import annotations

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

# Allocations whose contents are undefined until written: not results.
_UNINITIALIZED = ("empty", "empty_like", "empty_strided", "new_empty",
                  "new_empty_strided")


class NaNTrap(TorchDispatchMode):
    """Raises FloatingPointError on the first aten op whose floating
    output holds a NaN; `ops` counts the ops it checked."""

    def __init__(self):
        super().__init__()
        self.ops = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        if func.overloadpacket.__name__ in _UNINITIALIZED:
            return out
        self.ops += 1
        for t in tree_leaves(out):
            if (isinstance(t, torch.Tensor) and t.is_floating_point()
                    and bool(torch.isnan(t).any())):
                raise FloatingPointError(
                    f"NaN in the output of {func} (checked op "
                    f"{self.ops}, shape {tuple(t.shape)})")
        return out


def checked(fn):
    """Wrap `fn` with the NaN trap: a callable with the same signature that
    raises FloatingPointError on the first NaN any aten op makes inside it
    instead of propagating it. Debug tool (every op waits for its check),
    for small repros, and on CPU tensors (see the module docstring):

        render_dbg = debug.checked(functools.partial(
            integrator.render, config=cfg, device="cpu"))
        out = render_dbg(scene, cam, env, seed)   # raises on hidden NaNs
    """
    def wrapped(*args, **kwargs):
        with NaNTrap():
            return fn(*args, **kwargs)

    return wrapped


def audit_buffers(buffers: dict, *, name: str = "render") -> dict:
    """Count non-finite values per buffer; returns {buffer: bad_count}.

    Use alongside colorspace.scrub_non_finite: the scrub keeps images
    presentable (the reference engine's behavior), the audit tells you the
    scrub fired and where.
    """
    report = {}
    for key, buf in buffers.items():
        bad = int((~torch.isfinite(torch.as_tensor(buf))).sum())
        if bad:
            report[key] = bad
    return report
