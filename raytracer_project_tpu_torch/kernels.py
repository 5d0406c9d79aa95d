"""Build and load the hand-written CUDA kernels (csrc/*.cu).

Each source is compiled by nvcc into a shared library with a plain C
interface under <repo>/build/torch_kernels/ and loaded with ctypes. The
build happens at first use, on the machine with the card: all sources are
compiled at once, one nvcc process each. A library newer than its source
is reused.

Every C entry takes pointers and the stream as `void*`, launches on
PyTorch's current stream, allocates nothing, and returns
`cudaGetLastError()`; `check` raises on a non-zero code. The libraries
link the CUDA runtime statically and launch on the calling thread's
current device, so `launch` raises unless every tensor lies on that
device. Loading and the wrappers' launch counts (`count`) are safe from
several threads at once: parallel/render.py renders each window of a
mesh in a thread of its own. While a thread captures a CUDA graph, the
counts its launches would add are held (`held_counts`) and added once per
replay (`count_all`).
"""

from __future__ import annotations

import contextlib
import ctypes
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

_CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
SOURCES = ("closest_hit", "bvh_hit", "decode", "shade_advance",
           "probe_a1_ablate", "probe_onehot", "probe_decode", "launch_floor")

# --fmad=false keeps every a*b+c as a rounded product and a rounded sum,
# the arithmetic of the plain PyTorch versions; fmaf() stays an FMA.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
              "-Xptxas", "-v")

_P, _I, _U, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint, ctypes.c_float
# C entry point -> (source, argument types, the stream last); every entry
# returns the launch's cudaGetLastError() as int.
SIGNATURES = {
    "closest_hit_od": ("closest_hit", [_P, _I, _F] + [_P, _P, _I] * 3
                       + [_P, _P, _P, _P]),
    "closest_hit_feats": ("closest_hit", [_P, _I, _F] + [_P, _P, _I] * 3
                          + [_P, _P, _P, _P]),
    "closest_hit_od_dense": ("closest_hit", [_P, _I, _F] + [_P, _I, _P, _I] * 3
                             + [_P, _P, _P, _P]),
    "closest_hit_feats_dense": ("closest_hit", [_P, _I, _F]
                                + [_P, _I, _P, _I] * 3 + [_P, _P, _P, _P]),
    "bvh_closest_hit": ("bvh_hit", [_P, _I, _F] + [_P] * 9),
    "bvh_walk_counted": ("bvh_hit", [_P, _I, _F] + [_P] * 10),
    "decode_launch": ("decode", [_P, _P, _P, _P, _I, _P, _P, _I, _P, _I, _P,
                                 _I, _I, _I, _I, _F, _F, _I, _F, _F, _P, _P]),
    "shade_advance_launch": ("shade_advance",
                             [_P, _P, _P, _I, _P, _P, _P, _P, _P, _U, _I, _I,
                              _I, _F, _I, _F, _I, _I, _I, _I, _F, _I, _I, _I,
                              _I, _I] + [_P] * 11),
    "shade_accumulate_launch": ("shade_advance",
                                [_P] * 5 + [_I] + [_P] * 5
                                + [_U, _I, _I, _I, _F, _I, _F, _I, _I, _I, _I,
                                   _F, _I, _I, _I, _I, _I]
                                + [_P, _P, _I, _P, _I, _P, _I, _I, _I, _I,
                                   _F, _F, _I, _F, _F, _I] + [_P] * 13),
    "pool_start_launch": ("shade_advance",
                          [_I, _P, _U, _I, _I, _I, _F, _I, _F, _I, _I, _I]
                          + [_P] * 7),
    "step_inputs_launch": ("shade_advance", [_P, _U, _I, _I, _P, _P, _I, _P,
                                             _P, _I, _P, _P]),
    "copy_async_launch": ("shade_advance", [_P, _P, _I, _P]),
    "probe_a1_ablate": ("probe_a1_ablate", [_I, _P, _I, _F] + [_P, _P, _I] * 3
                        + [_I, _P, _P, _P, _P]),
    "probe_onehot": ("probe_onehot", [_I, _I, _I, _I, _P, _P, _P, _I, _I, _P,
                                      _P, _I, _P]),
    "launch_floor": ("launch_floor", [_I, _P]),
    "probe_decode_stage": ("probe_decode", [_I, _P, _P, _P, _P, _I, _P, _I, _P,
                                            _I, _P, _I, _I, _I, _I, _P, _P]),
}

_loaded: dict[str, ctypes.CDLL] = {}
_entries: dict = {}
# Held while a library is built or loaded, and while a count is updated.
_load_lock = threading.RLock()
_count_lock = threading.Lock()
# Per thread: the list that holds its counts while it captures, or None.
_held = threading.local()


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found: the CUDA kernels build only on a "
                       "machine with the CUDA toolkit")


def _lib_path(name: str) -> Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    if not lib.exists():
        return True
    deps = [_CSRC / f"{name}.cu", *_CSRC.glob("*.cuh")]
    return lib.stat().st_mtime < max(p.stat().st_mtime for p in deps)


def build_all(force: bool = False, names=SOURCES) -> float:
    """Compile every stale source of `names` in parallel; returns the wall
    seconds (0.0 when none was stale). The compiler's resource report goes
    to build/torch_kernels/<name>.log."""
    todo = [n for n in names if force or _stale(n)]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = []
    for name in todo:
        log = open(BUILD_DIR / f"{name}.log", "w")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(_lib_path(name)),
               str(_CSRC / f"{name}.cu")]
        procs.append((name, log, subprocess.Popen(
            cmd, stdout=log, stderr=subprocess.STDOUT)))
    failed = []
    for name, log, proc in procs:
        rc = proc.wait()
        log.close()
        if rc:
            failed.append(name)
    if failed:
        msgs = "\n".join(
            f"--- {n}\n{(BUILD_DIR / f'{n}.log').read_text()[-4000:]}"
            for n in failed)
        raise RuntimeError(f"nvcc failed for {failed}:\n{msgs}")
    return time.perf_counter() - t0


def load(name: str) -> ctypes.CDLL:
    """The loaded library of csrc/<name>.cu, building it first if needed."""
    with _load_lock:
        lib = _loaded.get(name)
        if lib is None:
            if _stale(name):
                build_all()
            lib = ctypes.CDLL(str(_lib_path(name)))
            _loaded[name] = lib
        return lib


def _entry(entry: str):
    """C entry `entry` with its argument and result types declared."""
    with _load_lock:
        fn = _entries.get(entry)
        if fn is None:
            source, argtypes = SIGNATURES[entry]
            fn = getattr(load(source), entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _entries[entry] = fn
        return fn


def launch(entry: str, *args) -> None:
    """Call C entry `entry` on PyTorch's current stream (appended as the
    last argument); tensors pass as their data pointers. Raises if a
    tensor lies on another device than the calling thread's current one
    (the stream's and the launch's), or if the launch failed."""
    fn = _entry(entry)
    cur = torch.cuda.current_device()
    vals = []
    for a in args:
        if isinstance(a, torch.Tensor):
            if a.get_device() != cur:
                raise RuntimeError(
                    f"{entry}: a tensor on {a.device}, but the calling "
                    f"thread's current device is cuda:{cur}; launch inside "
                    f"torch.cuda.device({a.device})")
            a = a.data_ptr()
        vals.append(a)
    vals.append(torch.cuda.current_stream().cuda_stream)
    if len(vals) != len(fn.argtypes):
        # ctypes would pass the surplus as 32-bit ints, cutting pointers.
        raise TypeError(f"{entry}: {len(vals)} arguments with the stream, "
                        f"its signature has {len(fn.argtypes)}")
    check(fn(*vals), entry)


def count(wrapper, attr: str = "launches") -> None:
    """Add one to a wrapper's launch count `wrapper.<attr>` (or hold the
    count, inside `held_counts`)."""
    held = getattr(_held, "counts", None)
    if held is not None:
        held.append((wrapper, attr))
        return
    with _count_lock:
        setattr(wrapper, attr, getattr(wrapper, attr) + 1)


def count_all(pairs) -> None:
    """Add one to `wrapper.<attr>` for each (wrapper, attr) of pairs."""
    with _count_lock:
        for wrapper, attr in pairs:
            setattr(wrapper, attr, getattr(wrapper, attr) + 1)


def tally(wrapper, **amounts) -> None:
    """Add each amount to the process-wide total `wrapper.<name>`."""
    with _count_lock:
        for attr, n in amounts.items():
            setattr(wrapper, attr, getattr(wrapper, attr) + n)


@contextlib.contextmanager
def held_counts():
    """The block's counts in this thread, held and not added: yields the
    list of their (wrapper, attr) pairs, in order. A CUDA graph's capture
    launches nothing, so its launches count when it replays (`count_all`)."""
    prev = getattr(_held, "counts", None)
    _held.counts = held = []
    try:
        yield held
    finally:
        _held.counts = prev


def check(code: int, what: str) -> None:
    if code != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {code}")


def require_cuda(*tensors: torch.Tensor, dtype=None) -> None:
    """Raise unless every tensor is contiguous on one CUDA device (and of
    `dtype`, when given): what the kernels' raw pointers assume."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev or t.device.type != "cuda":
            raise ValueError(f"kernel input on {t.device}, expected {dev} (cuda)")
        if not t.is_contiguous():
            raise ValueError("kernel inputs must be contiguous")
        if dtype is not None and t.dtype != dtype:
            raise ValueError(f"kernel input dtype {t.dtype}, expected {dtype}")
