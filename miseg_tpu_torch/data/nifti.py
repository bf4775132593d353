"""Minimal NIfTI-1 reader/writer in pure numpy (.nii / .nii.gz): the
port's copy of `miseg_tpu/data/nifti.py`.

A fixed 348-byte header plus raw voxels.  Supports the datatypes MM-WHS
uses ((u)int8/16/32/64, float32/64), scl_slope/inter scaling, and
sform/qform affines; writes an sform affine, gzip-compressed at the
`gzip` module's default level (9) for a `.gz` path, as the JAX package
does.
"""

from __future__ import annotations

import dataclasses
import gzip
import struct
from pathlib import Path

import numpy as np

_DTYPES = {
    2: np.uint8, 4: np.int16, 8: np.int32, 16: np.float32, 64: np.float64,
    256: np.int8, 512: np.uint16, 768: np.uint32, 1024: np.int64,
    1280: np.uint64,
}
_CODES = {np.dtype(v): k for k, v in _DTYPES.items()}


@dataclasses.dataclass
class NiftiImage:
    data: np.ndarray           # [X, Y, Z] (or [X, Y, Z, T]) voxel array
    affine: np.ndarray         # 4x4 voxel→world (RAS+) affine

    @property
    def spacing(self) -> np.ndarray:
        return np.linalg.norm(self.affine[:3, :3], axis=0)


def _quaternion_affine(hdr: dict) -> np.ndarray:
    b, c, d = hdr["quatern_b"], hdr["quatern_c"], hdr["quatern_d"]
    a = np.sqrt(max(0.0, 1.0 - (b * b + c * c + d * d)))
    qfac = hdr["pixdim"][0] if hdr["pixdim"][0] in (-1.0, 1.0) else 1.0
    R = np.array([
        [a * a + b * b - c * c - d * d, 2 * (b * c - a * d), 2 * (b * d + a * c)],
        [2 * (b * c + a * d), a * a + c * c - b * b - d * d, 2 * (c * d - a * b)],
        [2 * (b * d - a * c), 2 * (c * d + a * b), a * a + d * d - b * b - c * c],
    ])
    spacing = np.array(hdr["pixdim"][1:4])
    R = R * spacing
    R[:, 2] *= qfac
    aff = np.eye(4)
    aff[:3, :3] = R
    aff[:3, 3] = [hdr["qoffset_x"], hdr["qoffset_y"], hdr["qoffset_z"]]
    return aff


def _parse_header(raw: bytes) -> dict:
    if len(raw) < 348:
        raise ValueError("truncated NIfTI header")
    sizeof_hdr = struct.unpack_from("<i", raw, 0)[0]
    endian = "<"
    if sizeof_hdr != 348:
        sizeof_hdr = struct.unpack_from(">i", raw, 0)[0]
        if sizeof_hdr != 348:
            raise ValueError("not a NIfTI-1 file")
        endian = ">"
    u = lambda fmt, off: struct.unpack_from(endian + fmt, raw, off)
    hdr = {
        "endian": endian,
        "dim": u("8h", 40),
        "datatype": u("h", 70)[0],
        "bitpix": u("h", 72)[0],
        "pixdim": u("8f", 76),
        "vox_offset": u("f", 108)[0],
        "scl_slope": u("f", 112)[0],
        "scl_inter": u("f", 116)[0],
        "qform_code": u("h", 252)[0],
        "sform_code": u("h", 254)[0],
        "quatern_b": u("f", 256)[0],
        "quatern_c": u("f", 260)[0],
        "quatern_d": u("f", 264)[0],
        "qoffset_x": u("f", 268)[0],
        "qoffset_y": u("f", 272)[0],
        "qoffset_z": u("f", 276)[0],
        "srow_x": u("4f", 280),
        "srow_y": u("4f", 296),
        "srow_z": u("4f", 312),
        "magic": raw[344:348],
    }
    return hdr


def load_nifti(path: str | Path, *, dtype=None) -> NiftiImage:
    path = Path(path)
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "rb") as f:
        raw = f.read()
    hdr = _parse_header(raw[:348])
    ndim = hdr["dim"][0]
    shape = tuple(hdr["dim"][1:1 + ndim])
    # squeeze trailing singleton dims (common 4D [X,Y,Z,1] files)
    while len(shape) > 3 and shape[-1] == 1:
        shape = shape[:-1]
    np_dtype = _DTYPES.get(hdr["datatype"])
    if np_dtype is None:
        raise ValueError(f"unsupported NIfTI datatype {hdr['datatype']}")
    offset = int(hdr["vox_offset"]) or 352
    count = int(np.prod(shape))
    arr = np.frombuffer(raw, dtype=np.dtype(np_dtype).newbyteorder(hdr["endian"]),
                        count=count, offset=offset)
    data = arr.reshape(shape, order="F").astype(np_dtype)
    slope, inter = hdr["scl_slope"], hdr["scl_inter"]
    if slope not in (0.0, 1.0) or inter not in (0.0,):
        if slope == 0.0:
            slope = 1.0
        data = data.astype(np.float32) * slope + inter
    if hdr["sform_code"] > 0:
        affine = np.array([hdr["srow_x"], hdr["srow_y"], hdr["srow_z"],
                           [0, 0, 0, 1]], dtype=np.float64)
    elif hdr["qform_code"] > 0:
        affine = _quaternion_affine(hdr)
    else:
        affine = np.diag([*hdr["pixdim"][1:4], 1.0]).astype(np.float64)
    if dtype is not None:
        data = data.astype(dtype)
    return NiftiImage(data=np.ascontiguousarray(data), affine=affine)


def save_nifti(path: str | Path, data: np.ndarray, affine: np.ndarray) -> None:
    path = Path(path)
    data = np.asarray(data)
    if data.dtype == np.bool_:
        data = data.astype(np.uint8)
    if np.dtype(data.dtype) not in _CODES:
        data = data.astype(np.float32)
    code = _CODES[np.dtype(data.dtype)]
    bitpix = data.dtype.itemsize * 8
    ndim = data.ndim
    dim = [ndim] + list(data.shape) + [1] * (7 - ndim)
    spacing = np.linalg.norm(np.asarray(affine)[:3, :3], axis=0)
    pixdim = [1.0] + list(spacing) + [0.0] * (7 - max(3, ndim))
    pixdim = (pixdim + [0.0] * 8)[:8]

    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, *dim)
    struct.pack_into("<h", hdr, 70, code)
    struct.pack_into("<h", hdr, 72, bitpix)
    struct.pack_into("<8f", hdr, 76, *pixdim)
    struct.pack_into("<f", hdr, 108, 352.0)   # vox_offset
    struct.pack_into("<f", hdr, 112, 1.0)     # scl_slope
    struct.pack_into("<f", hdr, 116, 0.0)     # scl_inter
    struct.pack_into("<h", hdr, 252, 0)       # qform_code
    struct.pack_into("<h", hdr, 254, 1)       # sform_code (aligned)
    aff = np.asarray(affine, dtype=np.float32)
    struct.pack_into("<4f", hdr, 280, *aff[0])
    struct.pack_into("<4f", hdr, 296, *aff[1])
    struct.pack_into("<4f", hdr, 312, *aff[2])
    hdr[344:348] = b"n+1\x00"

    payload = bytes(hdr) + b"\x00" * 4 + np.asfortranarray(data).tobytes(order="F")
    opener = gzip.open if path.suffix == ".gz" else open
    with opener(path, "wb") as f:
        f.write(payload)
