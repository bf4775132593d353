"""The port's host data layer against the JAX package (CPU): NIfTI IO,
the C++ resampler, each deterministic transform forward and inverse, the
evaluation chain and the datalist loader.

Every case feeds the same bytes or arrays to both packages.  Exact
equality everywhere but resampling, which is held at atol 1e-5 (f32
trilinear weights summed in double by the same C++ source, built twice).
"""

import gzip
import math
import struct
from pathlib import Path

import numpy as np
import pytest
from scipy import ndimage
from scipy.spatial.transform import Rotation

from miseg_tpu.config import Config as JConfig
from miseg_tpu.data import transforms as JT
from miseg_tpu.data.datalist import load_decathlon_datalist_with_modality as jax_datalist
from miseg_tpu.data.multi_modal import eval_transforms as jax_eval_transforms
from miseg_tpu.data.nifti import load_nifti as jax_load_nifti
from miseg_tpu.data.nifti import save_nifti as jax_save_nifti
from miseg_tpu_torch.config import Config
from miseg_tpu_torch.data import transforms as TT
from miseg_tpu_torch.data.datalist import load_decathlon_datalist_with_modality
from miseg_tpu_torch.data.multi_modal import eval_transforms
from miseg_tpu_torch.data.nifti import load_nifti, save_nifti
from miseg_tpu_torch.utils import native

ROOT = Path(__file__).resolve().parents[1]
ATOL_RESAMPLE = 1e-5


def oblique_lps_affine() -> np.ndarray:
    """A slightly oblique LPS affine with anisotropic spacing (1.3, 0.9,
    1.7 mm) and a non-zero origin."""
    aff = np.eye(4)
    rot = Rotation.from_euler("xyz", [6, -4, 3], degrees=True).as_matrix()
    aff[:3, :3] = rot @ np.diag([-1.3, -0.9, 1.7])
    aff[:3, 3] = [12.5, -7.25, 30.0]
    return aff


def scan(path: Path, shape=(21, 17, 13), seed: int = 0, dtype=np.float32) -> Path:
    rng = np.random.default_rng(seed)
    data = (rng.random(shape) * 400 - 100).astype(dtype)
    save_nifti(path, data, oblique_lps_affine())
    return path


# ---------------------------------------------------------------- NIfTI

@pytest.mark.parametrize("suffix", [".nii", ".nii.gz"])
@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("dtype", [np.int16, np.uint8, np.float32, np.float64])
def test_nifti_round_trip_across_packages(tmp_path, suffix, writer, dtype):
    rng = np.random.default_rng(1)
    data = (rng.random((9, 7, 5)) * 100).astype(dtype)
    aff = oblique_lps_affine()
    path = tmp_path / f"x{suffix}"
    (save_nifti if writer == "port" else jax_save_nifti)(path, data, aff)
    ours, theirs = load_nifti(path), jax_load_nifti(path)
    assert ours.data.dtype == theirs.data.dtype == dtype
    assert np.array_equal(ours.data, theirs.data) and np.array_equal(ours.data, data)
    assert np.array_equal(ours.affine, theirs.affine)
    np.testing.assert_allclose(ours.affine, aff, atol=1e-5)
    if suffix == ".nii.gz":
        assert path.read_bytes()[:2] == b"\x1f\x8b"


def _header(data: np.ndarray, *, sform=None, quat=None, qoffset=(0, 0, 0),
            pixdim=(1.0, 1.0, 1.0), qfac=1.0, slope=1.0, inter=0.0) -> bytes:
    """A NIfTI-1 file written field by field: sform rows, or a qform
    quaternion (b, c, d) with its offset, pixdim and qfac."""
    codes = {np.dtype(np.int16): 4, np.dtype(np.float32): 16}
    hdr = bytearray(348)
    struct.pack_into("<i", hdr, 0, 348)
    struct.pack_into("<8h", hdr, 40, 3, *data.shape, 1, 1, 1, 1)
    struct.pack_into("<h", hdr, 70, codes[data.dtype])
    struct.pack_into("<h", hdr, 72, data.dtype.itemsize * 8)
    struct.pack_into("<8f", hdr, 76, qfac, *pixdim, 0, 0, 0, 0)
    struct.pack_into("<f", hdr, 108, 352.0)
    struct.pack_into("<f", hdr, 112, slope)
    struct.pack_into("<f", hdr, 116, inter)
    if quat is not None:
        struct.pack_into("<h", hdr, 252, 1)
        struct.pack_into("<3f", hdr, 256, *quat)
        struct.pack_into("<3f", hdr, 268, *qoffset)
    if sform is not None:
        struct.pack_into("<h", hdr, 254, 1)
        for i in range(3):
            struct.pack_into("<4f", hdr, 280 + 16 * i, *sform[i])
    hdr[344:348] = b"n+1\x00"
    return bytes(hdr) + b"\x00" * 4 + np.asfortranarray(data).tobytes(order="F")


_ROT = Rotation.from_euler("zyx", [20, -10, 5], degrees=True)


@pytest.mark.parametrize("form", ["sform", "qform", "qform-qfac", "scl", "none"])
def test_nifti_header_forms_match_jax(tmp_path, form):
    """sform-only, qform-only (with qfac -1 too), scl_slope/scl_inter and
    a header with neither affine: both packages read the same data and
    affine, and the affine is the one the header encodes."""
    rng = np.random.default_rng(2)
    data = (rng.random((6, 5, 4)) * 1000).astype(np.int16)
    pixdim = (0.8, 1.1, 2.5)
    want_data = data
    b, c, d, a = _ROT.as_quat()  # scipy: (x, y, z, w)
    if a < 0:
        b, c, d = -b, -c, -d
    offset = (3.0, -4.5, 7.25)
    want_aff = np.eye(4)
    if form == "sform":
        rows = np.array([[0.0, -1.5, 0.1, 10], [2.0, 0.0, 0.0, -5], [0.0, 0.2, 2.5, 3]])
        raw = _header(data, sform=rows)
        want_aff[:3] = rows
    elif form.startswith("qform"):
        qfac = -1.0 if form == "qform-qfac" else 1.0
        raw = _header(data, quat=(b, c, d), qoffset=offset, pixdim=pixdim, qfac=qfac)
        want_aff[:3, :3] = _ROT.as_matrix() * np.array(pixdim) * np.array([1, 1, qfac])
        want_aff[:3, 3] = offset
    elif form == "scl":
        raw = _header(data, pixdim=pixdim, slope=0.5, inter=-1024.0)
        want_data = data.astype(np.float32) * np.float32(0.5) + np.float32(-1024.0)
        want_aff = np.diag([*pixdim, 1.0])
    else:
        raw = _header(data, pixdim=pixdim)
        want_aff = np.diag([*pixdim, 1.0])
    for suffix, payload in ((".nii", raw), (".nii.gz", gzip.compress(raw))):
        path = tmp_path / f"h{suffix}"
        path.write_bytes(payload)
        ours, theirs = load_nifti(path), jax_load_nifti(path)
        assert ours.data.dtype == theirs.data.dtype
        assert np.array_equal(ours.data, theirs.data)
        assert np.array_equal(ours.affine, theirs.affine)
        assert np.array_equal(ours.data, want_data)
        np.testing.assert_allclose(ours.affine, want_aff, atol=1e-5)


def test_nifti_rejects_garbage(tmp_path):
    path = tmp_path / "bad.nii"
    path.write_bytes(b"not a nifti" * 40)
    with pytest.raises(ValueError, match="NIfTI"):
        load_nifti(path)


# -------------------------------------------------------------- resampler

@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("order", [0, 1])
def test_resampler_matches_scipy(seed, order):
    """The port's build of `resample_affine_f32` against scipy.  Trilinear
    is scipy's `mode="constant"`.  Nearest rounds the coordinate before
    its bounds test (a point within half a voxel outside the edge takes
    the edge voxel), which is scipy's `mode="grid-constant"` at order 0;
    "constant" would zero that half-voxel rim instead."""
    rng = np.random.default_rng(seed)
    vol = (rng.random((19, 23, 17)) + 1.0).astype(np.float32)
    matrix = np.eye(3) + 0.15 * rng.standard_normal((3, 3))
    offset = rng.standard_normal(3) * 2 + 0.0137
    out_shape = (25, 16, 21)
    got = native.resample_affine(vol, matrix, offset, out_shape, order)
    want = ndimage.affine_transform(
        vol, matrix, offset=offset, output_shape=out_shape, order=order,
        mode="grid-constant" if order == 0 else "constant", cval=0.0, prefilter=False)
    assert got.dtype == np.float32 and got.shape == out_shape
    np.testing.assert_allclose(got, want, rtol=0, atol=ATOL_RESAMPLE)
    assert np.count_nonzero(got) > got.size // 4  # the grid overlaps the volume


def test_resampler_checks_its_arguments():
    vol = np.zeros((4, 4, 4), np.float32)
    with pytest.raises(ValueError, match="order"):
        native.resample_affine(vol, np.eye(3), np.zeros(3), (4, 4, 4), 3)
    with pytest.raises(ValueError, match="3-D"):
        native.resample_affine(vol[0], np.eye(3), np.zeros(3), (4, 4, 4), 1)


def test_resampler_build_raises_without_compiler(monkeypatch):
    """No g++, no resampler: the build raises, and nothing falls back."""
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native.shutil, "which", lambda name: None)
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        native.resample_affine(np.zeros((2, 2, 2), np.float32), np.eye(3),
                               np.zeros(3), (2, 2, 2), 1)


def test_resampler_build_raises_on_compiler_error(tmp_path, monkeypatch):
    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(native, "SOURCE", bad)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.load()
    assert not any((tmp_path / "build").glob("*.so"))


# ------------------------------------------------------------- transforms

def _pair(name):
    """(port transform, JAX transform) of one kind, same arguments."""
    keys = ["image", "label"]
    kinds = {
        "LoadImaged": lambda M: M.LoadImaged(keys=keys),
        "EnsureChannelLastd": lambda M: M.EnsureChannelLastd(keys=keys),
        "Orientationd": lambda M: M.Orientationd(keys=keys, axcodes="RAS"),
        "Spacingd": lambda M: M.Spacingd(keys=keys, pixdim=(1.0, 1.25, 1.5),
                                         mode=("bilinear", "nearest")),
        "ScaleIntensityd": lambda M: M.ScaleIntensityd(keys=["image"]),
        "SpatialPadd": lambda M: M.SpatialPadd(keys=keys, spatial_size=(24, 20, 32)),
        "ToTensord": lambda M: M.ToTensord(keys=keys),
    }
    return kinds[name](TT), kinds[name](JT)


_ORDER = ["LoadImaged", "EnsureChannelLastd", "Orientationd", "Spacingd",
          "ScaleIntensityd", "SpatialPadd", "ToTensord"]


def _input_of(name, path: Path) -> dict:
    """What `name` receives in the evaluation chain: the output of the
    port's transforms before it (image and label both from the scan)."""
    data = {"image": str(path), "label": str(path)}
    for prev in _ORDER[:_ORDER.index(name)]:
        data = _pair(prev)[0](data)
    return data


def _assert_same(a, b, atol):
    if isinstance(a, dict):
        assert a.keys() == b.keys()
        for k in a:
            _assert_same(a[k], b[k], atol)
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b)
        for x, y in zip(a, b):
            _assert_same(x, y, atol)
    elif isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype
        if atol:
            np.testing.assert_allclose(a, b, rtol=0, atol=atol)
        else:
            assert np.array_equal(a, b)
    else:
        assert a == b


@pytest.mark.parametrize("name", _ORDER)
def test_transform_matches_jax(tmp_path, name):
    """Each transform on the same input dict in both packages, forward
    (arrays, meta and op record) and, where it records an op, inverse.
    Exact, but Spacingd's arrays at atol 1e-5 (bilinear image, nearest
    label).  Every output array has non-negative strides."""
    path = scan(tmp_path / "s_image.nii.gz")
    ours_t, jax_t = _pair(name)
    x = _input_of(name, path)
    ours, theirs = ours_t(dict(x)), jax_t(dict(x))
    atol = ATOL_RESAMPLE if name == "Spacingd" else 0
    _assert_same({k: v for k, v in ours.items() if k != "_ops"},
                 {k: v for k, v in theirs.items() if k != "_ops"}, atol)
    _assert_same(ours.get("_ops", {}), theirs.get("_ops", {}), 0)
    for key in ("image", "label"):
        arr = np.asarray(ours[key]) if name != "LoadImaged" else ours[key]
        assert all(s >= 0 for s in arr.strides)
    for key, ops in ours.get("_ops", {}).items():
        op = ops[-1]
        if op["name"] != name:
            continue
        arr = np.asarray(ours[key], np.float32)
        back_ours = ours_t.inverse_op(arr, op)
        back_jax = jax_t.inverse_op(arr, op)
        _assert_same(np.asarray(back_ours), np.asarray(back_jax), atol)
        assert np.asarray(back_ours).shape[:3] == np.asarray(x[key]).shape[:3]


def test_transforms_recorded_for_every_invertible_step(tmp_path):
    path = scan(tmp_path / "r_image.nii.gz")
    out = _input_of("ToTensord", path)
    assert [op["name"] for op in out["_ops"]["label"]] == [
        "EnsureChannelLastd", "Orientationd", "Spacingd", "SpatialPadd"]


def test_orientation_copies_flips(tmp_path):
    """An LPS scan flips two axes; the result (and its inverse) must be
    contiguous, so it can reach `torch.from_numpy`."""
    import torch
    path = scan(tmp_path / "o_image.nii.gz")
    x = _input_of("Orientationd", path)
    out = TT.Orientationd(keys=["image"])(x)
    torch.from_numpy(out["image"])
    assert out["image"].flags["C_CONTIGUOUS"]
    back = TT.Orientationd(keys=["image"]).inverse_op(out["image"], out["_ops"]["image"][-1])
    assert back.flags["C_CONTIGUOUS"]
    assert np.array_equal(back, x["image"])


# ------------------------------------------------------ the evaluation chain

_CHAIN_CFG = dict(roi_x=32, roi_y=32, roi_z=32, space_x=1.2, space_y=0.9, space_z=1.4)


@pytest.mark.parametrize("shape,dtype", [((30, 26, 20), np.float32), ((17, 40, 23), np.int16)])
def test_eval_transforms_and_inverse_match_jax(tmp_path, shape, dtype):
    """`eval_transforms` (image also loaded as "label") and
    `Compose.inverse` of a label map in the preprocessed grid, against
    JAX's: the same arrays (atol 1e-5 where resampled), the same op
    records, and an inverse in the scan's own grid."""
    path = scan(tmp_path / "c_image.nii.gz", shape=shape, seed=3, dtype=dtype)
    ours_c = eval_transforms(Config(**_CHAIN_CFG), allow_missing_keys=True)
    jax_c = jax_eval_transforms(JConfig(**_CHAIN_CFG), allow_missing_keys=True)
    item = {"image": str(path), "label": str(path)}
    ours, theirs = ours_c(dict(item)), jax_c(dict(item))
    _assert_same({k: v for k, v in ours.items() if k != "_ops"},
                 {k: v for k, v in theirs.items() if k != "_ops"}, ATOL_RESAMPLE)
    _assert_same(ours["_ops"], theirs["_ops"], 0)
    spatial = ours["image"].shape[:3]
    assert all(s >= r for s, r in zip(spatial, (32, 32, 32)))
    labels = (np.random.default_rng(4).integers(0, 4, size=spatial)
              .astype(np.float32)[..., None])
    back_ours = ours_c.inverse({**ours, "label": labels}, key="label")["label"]
    back_jax = jax_c.inverse({**theirs, "label": labels}, key="label")["label"]
    assert back_ours.shape == shape
    assert np.array_equal(back_ours, back_jax)
    assert set(np.unique(back_ours)) <= {0.0, 1.0, 2.0, 3.0}
    # the preprocessed image itself comes back to the scan within a voxel
    # of interpolation: the chain is the identity on a constant volume
    ones = np.ones(spatial + (1,), np.float32)
    back = ours_c.inverse({**ours, "label": ones}, key="label")["label"]
    assert back.shape == shape and math.isclose(float(back.mean()), 1.0, abs_tol=0.05)


def test_eval_transforms_allow_missing_keys(tmp_path):
    path = scan(tmp_path / "m_image.nii.gz")
    out = eval_transforms(Config(**_CHAIN_CFG), allow_missing_keys=True)({"image": str(path)})
    assert "label" not in out and out["image"].shape[-1] == 1
    with pytest.raises(KeyError):
        eval_transforms(Config(**_CHAIN_CFG))({"image": str(path)})


# ----------------------------------------------------------------- datalist

@pytest.mark.parametrize("json_name,key", [("CT_test.json", "test"), ("MR.json", "test"),
                                           ("MR.json", "training"),
                                           ("CT_fold1.json", "validation")])
def test_datalist_matches_jax(json_name, key):
    base = ROOT / "dataset" / "MM-WHS"
    ours = load_decathlon_datalist_with_modality(base / json_name, True, key, base_dir=base)
    theirs = jax_datalist(base / json_name, True, key, base_dir=base)
    assert ours == theirs and ours
    assert {item["modality"] for item in ours} == {1 if json_name.startswith("MR") else 0}
    assert all(item["image"].startswith(str(base)) for item in ours)


def test_datalist_errors(tmp_path):
    with pytest.raises(ValueError, match="does not exist"):
        load_decathlon_datalist_with_modality(tmp_path / "none.json")
    (tmp_path / "d.json").write_text('{"training": []}')
    with pytest.raises(ValueError, match="test"):
        load_decathlon_datalist_with_modality(tmp_path / "d.json", True, "test")
