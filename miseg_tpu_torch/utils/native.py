"""ctypes bindings to the C++ host ops of `native/miseg_native.cpp`: the
resampler (`resample_affine_f32`), the exact 3-D Euclidean distance
transform (`edt3d_f32`) and the binary erosion (`binary_erosion_f32`)
that the surface distance reads.  The port's own build of the
repository's C ABI.

The library compiles with g++ at first use (`load()`), with the flags of
`native/Makefile`, into `_build/` beside this file (listed in
.gitignore).  Its name carries a hash of the source, the flags and the
CPU that `-march=native` resolves to, so an edited source, or a build
made on another CPU, is never loaded.  Nothing compiles at import.  A
missing compiler or a failed build raises: this path has no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[2] / "native" / "miseg_native.cpp"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-fopenmp", "-std=c++17", "-shared"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _compiler() -> str:
    cxx = shutil.which("g++")
    if cxx is None:
        raise RuntimeError("g++ not found: the host ops are built with g++ "
                           "(put it on PATH)")
    return cxx


def _native_arch(cxx: str) -> str:
    """What `-march=native` means to `cxx` on this CPU."""
    out = subprocess.run([cxx, "-march=native", "-Q", "--help=target"],
                         capture_output=True, text=True, timeout=60).stdout
    return " ".join(ln.split()[-1] for ln in out.splitlines()
                    if ln.strip().startswith(("-march=", "-mtune=")))


def library_path(cxx: str | None = None) -> Path:
    cxx = cxx or _compiler()
    key = SOURCE.read_bytes() + " ".join([*CXX_FLAGS, _native_arch(cxx)]).encode()
    return BUILD_DIR / f"libmiseg_native-{hashlib.sha256(key).hexdigest()[:12]}.so"


def load() -> ctypes.CDLL:
    """The loaded host-op library, compiled first if no current build
    exists.  Raises when the compiler is missing or fails."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        cxx = _compiler()
        out = library_path(cxx)
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            proc = subprocess.run([cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                                  capture_output=True, text=True, timeout=600)
            if proc.returncode != 0:
                tmp.unlink(missing_ok=True)
                raise RuntimeError(f"g++ failed for {SOURCE.name} (exit "
                                   f"{proc.returncode}):\n{proc.stdout}{proc.stderr}")
            os.replace(tmp, out)  # atomic: a reader never sees a partial library
        lib = ctypes.CDLL(str(out))
        lib.resample_affine_f32.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_double),
            ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int]
        lib.resample_affine_f32.restype = None
        u8 = ctypes.POINTER(ctypes.c_uint8)
        lib.edt3d_f32.argtypes = [u8, ctypes.POINTER(ctypes.c_int64),
                                  ctypes.POINTER(ctypes.c_float)]
        lib.edt3d_f32.restype = None
        lib.binary_erosion_f32.argtypes = [u8, ctypes.POINTER(ctypes.c_int64), u8]
        lib.binary_erosion_f32.restype = None
        _lib = lib
        return lib


def resample_affine(vol: np.ndarray, matrix: np.ndarray, offset: np.ndarray,
                    out_shape, order: int) -> np.ndarray:
    """f32 `out[o] = vol(matrix @ o + offset)` over a 3-D output grid of
    `out_shape`: nearest (`order` 0) or trilinear (`order` 1), 0 outside
    the input; `scipy.ndimage.affine_transform(..., order, mode="constant",
    prefilter=False)` computes the same."""
    if order not in (0, 1):
        raise ValueError(f"order must be 0 or 1, got {order}")
    vol = np.ascontiguousarray(vol, dtype=np.float32)
    m = np.ascontiguousarray(matrix, dtype=np.float64)
    off = np.ascontiguousarray(offset, dtype=np.float64)
    out_shape = tuple(int(s) for s in out_shape)
    if vol.ndim != 3 or len(out_shape) != 3 or m.shape != (3, 3) or off.shape != (3,):
        raise ValueError(f"want a 3-D volume, a 3x3 matrix, a 3-offset and a 3-D output "
                         f"shape; got {vol.shape}, {m.shape}, {off.shape}, {out_shape}")
    in_shape = np.asarray(vol.shape, dtype=np.int64)
    shape = np.asarray(out_shape, dtype=np.int64)
    out = np.empty(out_shape, dtype=np.float32)
    i64 = ctypes.POINTER(ctypes.c_int64)
    f64 = ctypes.POINTER(ctypes.c_double)
    load().resample_affine_f32(
        vol.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), in_shape.ctypes.data_as(i64),
        m.ctypes.data_as(f64), off.ctypes.data_as(f64),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), shape.ctypes.data_as(i64),
        ctypes.c_int(order))
    return out


def _mask3d(mask: np.ndarray) -> np.ndarray:
    m = np.ascontiguousarray(mask, dtype=np.uint8)
    if m.ndim != 3:
        raise ValueError(f"want a 3-D mask, got shape {m.shape}")
    return m


def edt(target: np.ndarray) -> np.ndarray:
    """f32 Euclidean distance (in voxels) from every voxel to the nearest
    true voxel of the 3-D mask `target`;
    `scipy.ndimage.distance_transform_edt(~target)` computes the same."""
    t = _mask3d(target)
    shape = np.asarray(t.shape, dtype=np.int64)
    out = np.empty(t.shape, dtype=np.float32)
    load().edt3d_f32(t.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                     shape.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                     out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return out


def binary_erosion(mask: np.ndarray) -> np.ndarray:
    """One erosion of the 3-D mask by the 6-neighbour cross, outside the
    volume counting as true; `scipy.ndimage.binary_erosion(mask,
    border_value=1)` computes the same."""
    m = _mask3d(mask)
    shape = np.asarray(m.shape, dtype=np.int64)
    out = np.empty(m.shape, dtype=np.uint8)
    u8 = ctypes.POINTER(ctypes.c_uint8)
    load().binary_erosion_f32(m.ctypes.data_as(u8),
                              shape.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
                              out.ctypes.data_as(u8))
    return out.astype(bool)
