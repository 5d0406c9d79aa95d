"""ctypes bindings for the port's copy of the host C++ runtime
(csrc/zenith_native.cpp; twin of raytracer_project_tpu/native).

The library does the host-side work of scene building and export: the
binned-SAH BVH build, OBJ parsing and the PNG writer. It is compiled with g++ at first use into
<repo>/build/native/ (one build per source change; concurrent processes
take a file lock) and loaded with ctypes. When it cannot be built, callers
take their pure-Python builders: ops/bvh.py, models/obj.py and
utils/image_io.py. Set
RAYTRACER_TPU_NO_NATIVE=1 to force them.
"""

from __future__ import annotations

import ctypes
import fcntl
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

_SRC = Path(__file__).resolve().parent.parent / "csrc" / "zenith_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "native"
# The reference package's flags, so both builds of the same source agree.
GXX_FLAGS = ("-O3", "-std=c++20", "-shared", "-fPIC", "-march=native")

_LOCK = threading.Lock()
_LIB: ctypes.CDLL | None = None
_TRIED = False


class _ZnBvh(ctypes.Structure):
    _fields_ = [
        ("node_min", ctypes.POINTER(ctypes.c_float)),
        ("node_max", ctypes.POINTER(ctypes.c_float)),
        ("escape", ctypes.POINTER(ctypes.c_int32)),
        ("first", ctypes.POINTER(ctypes.c_int32)),
        ("count", ctypes.POINTER(ctypes.c_int32)),
        ("level", ctypes.POINTER(ctypes.c_int32)),
        ("leaf_order", ctypes.POINTER(ctypes.c_int64)),
        ("n_nodes", ctypes.c_int32),
        ("n_prims", ctypes.c_int64),
        ("n_levels", ctypes.c_int32),
        ("max_leaf", ctypes.c_int32),
    ]


class _ZnMesh(ctypes.Structure):
    _fields_ = [
        ("v0", ctypes.POINTER(ctypes.c_double)),
        ("v1", ctypes.POINTER(ctypes.c_double)),
        ("v2", ctypes.POINTER(ctypes.c_double)),
        ("n0", ctypes.POINTER(ctypes.c_double)),
        ("n1", ctypes.POINTER(ctypes.c_double)),
        ("n2", ctypes.POINTER(ctypes.c_double)),
        ("count", ctypes.c_int64),
        ("has_normals", ctypes.c_int32),
    ]


def _compile(out: Path) -> bool:
    tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
    try:
        res = subprocess.run(["g++", *GXX_FLAGS, str(_SRC), "-o", str(tmp)],
                             capture_output=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired):
        return False
    if res.returncode != 0 or not tmp.exists():
        return False
    os.replace(tmp, out)
    return True


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    lib.zn_bvh_build.restype = ctypes.POINTER(_ZnBvh)
    lib.zn_bvh_build.argtypes = [
        ctypes.c_int64, ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_float), ctypes.c_int32, ctypes.c_int32]
    lib.zn_bvh_free.restype = None
    lib.zn_bvh_free.argtypes = [ctypes.POINTER(_ZnBvh)]
    lib.zn_obj_parse.restype = ctypes.POINTER(_ZnMesh)
    lib.zn_obj_parse.argtypes = [ctypes.c_char_p]
    lib.zn_mesh_free.restype = None
    lib.zn_mesh_free.argtypes = [ctypes.POINTER(_ZnMesh)]
    lib.zn_png_write.restype = ctypes.c_int32
    lib.zn_png_write.argtypes = [ctypes.c_char_p, ctypes.c_int32,
                                 ctypes.c_int32, ctypes.POINTER(ctypes.c_uint8)]
    lib.zn_version.restype = ctypes.c_char_p
    lib.zn_version.argtypes = []
    return lib


def _load() -> ctypes.CDLL | None:
    """The bound library, built first if it is missing or older than its
    source; None when it cannot be built or RAYTRACER_TPU_NO_NATIVE is set."""
    global _LIB, _TRIED
    with _LOCK:
        if _TRIED:
            return _LIB
        _TRIED = True
        if os.environ.get("RAYTRACER_TPU_NO_NATIVE") or not _SRC.exists():
            return None
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        lib_path = BUILD_DIR / "libzenith_native.so"
        with open(BUILD_DIR / "lock", "w") as lock:
            fcntl.flock(lock, fcntl.LOCK_EX)
            stale = (not lib_path.exists() or lib_path.stat().st_mtime
                     < _SRC.stat().st_mtime)
            if stale and not _compile(lib_path):
                return None
        try:
            _LIB = _bind(ctypes.CDLL(str(lib_path)))
        except OSError:
            return None
        return _LIB


def available() -> bool:
    return _load() is not None


def version() -> str | None:
    lib = _load()
    return None if lib is None else lib.zn_version().decode()


def _copy(ptr, shape, dtype) -> np.ndarray:
    return np.array(np.ctypeslib.as_array(ptr, shape=shape), dtype=dtype)


def build_bvh(pmin: np.ndarray, pmax: np.ndarray, leaf_size: int,
              bins: int = 16) -> dict | None:
    """Native binned-SAH flat threaded BVH of the primitive AABBs
    f32[n, 3]; None if the library is absent. Returns dict(node_min,
    node_max, escape, first, count, level, leaf_order, n_levels, max_leaf),
    the contract of ops/bvh.py's Python builder."""
    lib = _load()
    if lib is None:
        return None
    pmin = np.ascontiguousarray(pmin, np.float32)
    pmax = np.ascontiguousarray(pmax, np.float32)
    if pmin.ndim != 2 or pmin.shape[1] != 3 or pmax.shape != pmin.shape:
        raise ValueError(f"AABBs {pmin.shape} / {pmax.shape}, expected [n, 3]")
    n = pmin.shape[0]
    fptr = ctypes.POINTER(ctypes.c_float)
    res = lib.zn_bvh_build(n, pmin.ctypes.data_as(fptr),
                           pmax.ctypes.data_as(fptr), int(leaf_size), int(bins))
    if not res:
        return None
    try:
        c = res.contents
        nn = int(c.n_nodes)
        return dict(
            node_min=_copy(c.node_min, (nn, 3), np.float32),
            node_max=_copy(c.node_max, (nn, 3), np.float32),
            escape=_copy(c.escape, (nn,), np.int32),
            first=_copy(c.first, (nn,), np.int32),
            count=_copy(c.count, (nn,), np.int32),
            level=_copy(c.level, (nn,), np.int32),
            leaf_order=_copy(c.leaf_order, (n,), np.int64),
            n_levels=int(c.n_levels),
            max_leaf=int(c.max_leaf),
        )
    finally:
        lib.zn_bvh_free(res)


def parse_obj(path: str) -> dict | None:
    """Native OBJ parse: dict(v0, v1, v2, n0, n1, n2) of f64[T, 3] corners
    (normals None without vn records on every face); None if the library is
    absent or the file cannot be read."""
    lib = _load()
    if lib is None:
        return None
    res = lib.zn_obj_parse(os.fsencode(path))
    if not res:
        return None
    try:
        c = res.contents
        t = int(c.count)
        if t == 0:
            return dict(v0=np.zeros((0, 3)), v1=np.zeros((0, 3)),
                        v2=np.zeros((0, 3)), n0=None, n1=None, n2=None)
        out = {k: _copy(getattr(c, k), (t, 3), np.float64)
               for k in ("v0", "v1", "v2")}
        for k in ("n0", "n1", "n2"):
            out[k] = (_copy(getattr(c, k), (t, 3), np.float64)
                      if c.has_normals else None)
        return out
    finally:
        lib.zn_mesh_free(res)


def write_png(path: str, rgb_u8: np.ndarray) -> bool:
    """Write uint8 [H, W, 3] as an RGB PNG with the native writer; False
    if the library is absent or the write failed (the caller falls back)."""
    lib = _load()
    if lib is None:
        return False
    arr = np.ascontiguousarray(rgb_u8, np.uint8)
    h, w = arr.shape[:2]
    rc = lib.zn_png_write(os.fsencode(path), w, h,
                          arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
    return rc == 0
