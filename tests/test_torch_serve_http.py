"""The port's HTTP server (`miseg_tpu_torch.cli.serve`) over a real socket
on the CPU, against the JAX package's `InferenceService` over a JAX
bundle exported for the CPU from the same parameters.

Model: `swin_unetr` at feature_size 12, 32^3 ROI, f32, 4 classes, JAX
parameters seeded from numpy and carried over by
`weights.state_dict_from_jax`.  A standard-normal window through both
bundles agrees at atol 2e-4, the model tests' bound.  On a scan, whose
preprocessed intensities lie in [0, 1], JAX's own f32 logits sit about
1e-4 from a float64 evaluation (XLA:CPU's f32 sums lose digits in the
first swin block's instance norm, whose channels have std << |mean|
after the patch embedding, and window attention amplifies that), while
the port's sit within 2e-5 of it.  So scan logits are held to the
float64 evaluation at 2e-5 and to JAX at 5e-4, and labels in the scan's
grid equal JAX's wherever JAX's top two logits differ by more than
5e-4 (argmax ties may break either way).  The affine is exact.  Also
the routes (health, 404, JSON 400s, gzip transport), concurrent
requests, and the refusals: a version-1 bundle and a server asked for
without a card.
"""

import gzip
import json
import threading
import urllib.error
import urllib.request

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy.spatial.transform import Rotation
from test_torch_bridge import seeded_params

from miseg_tpu.cli.serve import InferenceService as JInferenceService
from miseg_tpu.config import Config as JConfig
from miseg_tpu.models import model_from_config as jax_model_from_config
from miseg_tpu.serve import export_bundle as jax_export_bundle
from miseg_tpu.serve import load_bundle as jax_load_bundle
from miseg_tpu_torch.cli import serve as S
from miseg_tpu_torch.config import Config
from miseg_tpu_torch.data.nifti import load_nifti, save_nifti
from miseg_tpu_torch.inferers import SlidingWindowInferer
from miseg_tpu_torch.models import model_from_config
from miseg_tpu_torch.models import swin_transformer as ST
from miseg_tpu_torch.ops import norms as ON
from miseg_tpu_torch.ops.kernels import fused_norm as FN
from miseg_tpu_torch.serve import export_bundle, load_bundle, save_bundle
from miseg_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(1)
ATOL = 2e-4       # a standard-normal window, port against JAX
ATOL_SCAN = 5e-4  # scan logits, port against JAX (JAX's f32 error ~1e-4)
ATOL_F64 = 2e-5   # scan logits, port against a float64 evaluation
CFG = dict(model_name="swin_unetr", out_channels=4, feature_size=[12], num_heads=2,
           depth_swin_block=[2], roi_x=32, roi_y=32, roi_z=32,
           encoder_norm_name="instance_cond", vit_norm_name="instance_cond",
           decoder_norm_name="instance", no_amp=True, precision="fp32",
           space_x=1.0, space_y=1.0, space_z=1.0)


def write_scan(path, shape, spacing, seed, *, lps=True, dtype=np.float32):
    """A smooth synthetic scan with a slightly oblique (LPS or RAS) affine."""
    rng = np.random.default_rng(seed)
    grids = np.meshgrid(*[np.linspace(-1, 1, n) for n in shape], indexing="ij")
    vol = sum(rng.uniform(0.5, 2) * np.cos(rng.uniform(1, 4) * g + rng.uniform(0, 3))
              for g in grids) * 100 + rng.normal(0, 5, shape)
    aff = np.eye(4)
    rot = Rotation.from_euler("xyz", rng.uniform(-5, 5, 3), degrees=True).as_matrix()
    aff[:3, :3] = rot @ np.diag(np.array(spacing) * ([-1, -1, 1] if lps else 1))
    aff[:3, 3] = rng.uniform(-50, 50, 3)
    save_nifti(path, vol.astype(dtype), aff)
    return path


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """JAX params, the JAX service over its exported bundle, and the port's
    server over a bundle of the same weights, serving on a thread."""
    root = tmp_path_factory.mktemp("serve_http_torch")
    jcfg = JConfig(**CFG)
    jmodel = jax_model_from_config(jcfg)
    params = seeded_params(jmodel, jnp.zeros((1, 32, 32, 32, 1)), jnp.zeros((1,), jnp.int32))
    jservice = JInferenceService(jax_load_bundle(
        jax_export_bundle(jcfg, params, root / "jax_bundle", platforms=("cpu",))))
    save_bundle(Config(**CFG), state_dict_from_jax(params), root / "bundle")
    server = S.make_server(str(root / "bundle"), port=0, device="cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    # 30 x 26 x 20 at (1.3, 1.1, 1.6) mm: 39 x 29 x 32 at 1 mm (padded to
    # 39 x 32 x 32), two windows
    scan = write_scan(root / "scan_image.nii.gz", (30, 26, 20), (1.3, 1.1, 1.6), seed=5)
    yield {"root": root, "jservice": jservice, "server": server,
           "url": f"http://127.0.0.1:{server.server_port}", "scan": scan}
    server.shutdown()
    server.server_close()
    thread.join(timeout=30)


def _float64_norms(monkeypatch):
    """The port's plain norms in float64 throughout (statistics, affine,
    residual and leaky-relu), for a float64 evaluation of the unfused
    model; window attention keeps its f32 plain version."""
    def stats(x, dims, eps):
        x = x.double()
        mean = x.mean(dim=dims, keepdim=True)
        var = (x - mean).square().mean(dim=dims, keepdim=True)
        return mean, torch.rsqrt(var + eps)

    def layer_norm(x, gamma=None, beta=None, *, eps=1e-5):
        mean, inv = stats(x, (-1,), eps)
        y = (x.double() - mean) * inv
        return y if gamma is None else y * gamma.double() + beta.double()

    def instance_norm_act(x, gamma=None, beta=None, styles=None, *, eps=1e-5,
                          negative_slope=None, add=None):
        mean, inv = stats(x, tuple(range(1, x.ndim - 1)), eps)
        y = (x.double() - mean) * inv
        if gamma is not None:
            if styles is not None:
                idx = styles.long().clamp(0, gamma.shape[0] - 1)
                shape = (x.shape[0],) + (1,) * (x.ndim - 2) + (x.shape[-1],)
                gamma, beta = gamma[idx].reshape(shape), beta[idx].reshape(shape)
            y = y * gamma.double() + beta.double()
        if add is not None:
            y = y + add.double()
        if negative_slope is not None:
            y = torch.where(y >= 0, y, negative_slope * y)
        return y

    monkeypatch.setattr(ON, "layer_norm", layer_norm)
    monkeypatch.setattr(FN, "instance_norm_act", instance_norm_act)
    monkeypatch.setattr(ST, "layer_norm", layer_norm)
    monkeypatch.setattr(ST, "instance_norm_act", instance_norm_act)


def post(url, body, headers=None):
    req = urllib.request.Request(url, data=body, method="POST", headers=headers or {})
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, dict(r.headers), r.read()


def as_nifti(tmp_path, payload, name="answer.nii.gz"):
    path = tmp_path / name
    path.write_bytes(payload)
    return load_nifti(path)


def test_bundle_records_spacing(setup):
    meta = json.loads((setup["root"] / "bundle" / "meta.json").read_text())
    assert meta["bundle_version"] == 3
    assert meta["spacing"] == [1.0, 1.0, 1.0]
    assert meta["spacing"] == setup["jservice"].served.meta["spacing"]


def test_health(setup):
    with urllib.request.urlopen(f"{setup['url']}/health") as r:
        meta = json.loads(r.read())
    assert meta["status"] == "ok"
    assert meta["roi"] == [32, 32, 32] and meta["out_channels"] == 4
    assert meta["spacing"] == [1.0, 1.0, 1.0]
    assert meta["volume_programs"] == [] and meta["volume_programs_loaded"] == []
    assert meta["window_form"] == "arguments"


def test_errors_are_json_400s_and_unknown_routes_404(setup):
    for body in (b"", b"not a nifti"):
        with pytest.raises(urllib.error.HTTPError) as ei:
            post(f"{setup['url']}/predict?modality=0", body)
        assert ei.value.code == 400
        assert "error" in json.loads(ei.value.read())
    with pytest.raises(urllib.error.HTTPError) as ei:
        urllib.request.urlopen(f"{setup['url']}/nope")
    assert ei.value.code == 404
    with pytest.raises(urllib.error.HTTPError) as ei:
        post(f"{setup['url']}/other", b"x")
    assert ei.value.code == 404


def test_window_matches_jax(setup):
    """One standard-normal window through both bundles' window forward."""
    x = np.random.default_rng(7).standard_normal((1, 32, 32, 32, 1)).astype(np.float32)
    mods = np.array([1], np.int32)
    want = np.asarray(setup["jservice"].served(jnp.asarray(x), jnp.asarray(mods)))
    got = setup["server"].RequestHandlerClass.service.served(x, mods).numpy()
    assert np.abs(got - want).max() <= ATOL


def test_predict_matches_jax_service(setup, tmp_path, monkeypatch):
    """Logits on the preprocessed scan against a float64 evaluation
    (atol 2e-5) and JAX's (atol 5e-4), then the answer over HTTP against
    JAX's `infer` on the same bytes: labels equal wherever JAX's top-two
    margin exceeds 5e-4, the affine exact, in the scan's grid."""
    raw = setup["scan"].read_bytes()
    service = setup["server"].RequestHandlerClass.service
    sample = service.preprocess(raw)
    jsample = setup["jservice"].chain({"image": str(setup["scan"]),
                                       "label": str(setup["scan"])})
    assert np.array_equal(sample["image"].shape, jsample["image"].shape)
    np.testing.assert_allclose(sample["image"], jsample["image"], rtol=0, atol=1e-5)
    image = sample["image"][None]
    assert image.shape[1:4] == (39, 32, 32)
    want = np.asarray(setup["jservice"].served.predict(jnp.asarray(image),
                                                        jnp.asarray([1], jnp.int32)))
    got = service.served.predict(torch.from_numpy(image), [1]).numpy()
    assert got.shape == want.shape == (1, 39, 32, 32, 4)

    model64 = model_from_config(Config(**CFG), device="cpu", dtype=torch.float64,
                                fused_conv=False)
    model64.load_state_dict(service.served.state_dict())
    _float64_norms(monkeypatch)
    ref = SlidingWindowInferer(
        lambda w, m: model64(w.double(), m), roi_size=(32, 32, 32), overlap=0.5,
        mode="gaussian", out_channels=4, device="cpu")(
            torch.from_numpy(image).double(), torch.tensor([1], dtype=torch.int32)).numpy()
    monkeypatch.undo()
    err_ref, err_jax = np.abs(got - ref).max(), np.abs(got - want).max()
    print(f"scan logits max |diff|: port-float64 {err_ref:.2e}, port-jax {err_jax:.2e}, "
          f"jax-float64 {np.abs(want - ref).max():.2e}")
    assert err_ref <= ATOL_F64
    assert err_jax <= ATOL_SCAN

    top2 = np.sort(want[0], axis=-1)[..., -2:]
    decisive = (top2[..., 1] - top2[..., 0] > ATOL_SCAN).astype(np.float32)
    mask = service.chain.inverse({**sample, "label": decisive[..., None]}, key="label")["label"]

    status, headers, out = post(f"{setup['url']}/predict?modality=1", raw)
    assert status == 200 and headers["Content-Type"] == "application/gzip"
    stages = [p.split(";dur=")[0] for p in headers["Server-Timing"].split(", ")]
    assert stages == ["upload", "preprocess", "wait", "predict", "argmax", "inverse",
                      "encode", "total"]
    ours = as_nifti(tmp_path, out)
    theirs = as_nifti(tmp_path, setup["jservice"].infer(raw, 1), "jax.nii.gz")
    native = load_nifti(setup["scan"])
    assert ours.data.shape == native.data.shape == theirs.data.shape
    assert ours.data.dtype == np.uint16
    assert np.array_equal(ours.affine, native.affine)
    assert np.array_equal(ours.affine, theirs.affine)
    keep = mask > 0.5
    assert keep.mean() > 0.9
    assert np.array_equal(ours.data[keep], theirs.data[keep])
    assert set(np.unique(ours.data)) <= set(range(4))


def test_remap_whs_and_constant_blend(setup, tmp_path):
    raw = setup["scan"].read_bytes()
    _, _, out = post(f"{setup['url']}/predict?modality=0&remap=whs&mode=constant", raw)
    theirs = setup["jservice"].infer(raw, 0, mode="constant", remap="whs")
    ours, theirs = as_nifti(tmp_path, out), as_nifti(tmp_path, theirs, "jax.nii.gz")
    assert set(np.unique(ours.data)) <= {0, 500, 600, 420}
    assert (ours.data == theirs.data).mean() > 0.9


def test_gzip_body_transparently_decoded(setup, tmp_path):
    """A gzip Content-Encoding over an (already gzipped) .nii.gz body, and
    a plain .nii body, answer what the bare upload answers."""
    raw = setup["scan"].read_bytes()
    _, _, plain = post(f"{setup['url']}/predict?modality=1", raw)
    status, _, wrapped = post(f"{setup['url']}/predict?modality=1", gzip.compress(raw),
                              {"Content-Encoding": "gzip"})
    assert status == 200
    _, _, unzipped = post(f"{setup['url']}/predict?modality=1", gzip.decompress(raw))
    want = as_nifti(tmp_path, plain, "a.nii.gz").data
    assert np.array_equal(as_nifti(tmp_path, wrapped, "b.nii.gz").data, want)
    assert np.array_equal(as_nifti(tmp_path, unzipped, "c.nii.gz").data, want)


def test_concurrent_requests_match_serial(setup, tmp_path):
    """Six clients (three to a scan, one device lock) post two scans at
    once; every answer equals that scan's serial answer."""
    scans = [setup["scan"], write_scan(tmp_path / "b_image.nii.gz", (24, 20, 18),
                                       (1.2, 1.2, 1.5), seed=6, lps=False, dtype=np.int16)]
    serial = [post(f"{setup['url']}/predict?modality={i}", s.read_bytes())[2]
              for i, s in enumerate(scans)]
    want = [as_nifti(tmp_path, out, f"serial{i}.nii.gz").data for i, out in enumerate(serial)]
    results = {}
    barrier = threading.Barrier(6)

    def client(k):
        barrier.wait(timeout=60)
        results[k] = post(f"{setup['url']}/predict?modality={k % 2}",
                          scans[k % 2].read_bytes())

    threads = [threading.Thread(target=client, args=(k,)) for k in range(6)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=300)
    assert not any(t.is_alive() for t in threads)
    assert sorted(results) == list(range(6))
    for k, (status, _, out) in results.items():
        assert status == 200
        assert np.array_equal(as_nifti(tmp_path, out, f"c{k}.nii.gz").data, want[k % 2])


def test_version1_bundle_raises(setup, tmp_path):
    """A bundle without `spacing` (version 1) loads, but no preprocessing
    chain is built from it: the server would resample at a guessed scale."""
    meta = json.loads((setup["root"] / "bundle" / "meta.json").read_text())
    old = {k: v for k, v in meta.items() if k != "spacing"}
    old["bundle_version"] = 1
    with pytest.raises(ValueError, match="spacing"):
        S._eval_chain(old)
    v1 = tmp_path / "v1"
    v1.mkdir()
    (v1 / "meta.json").write_text(json.dumps(old))
    (v1 / "weights.pt").symlink_to(setup["root"] / "bundle" / "weights.pt")
    assert load_bundle(v1, device="cpu").meta["bundle_version"] == 1
    with pytest.raises(ValueError, match="spacing"):
        S.make_server(str(v1), port=0, device="cpu")


def test_make_server_needs_a_card_unless_asked_for_the_cpu(setup, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        S.make_server(str(setup["root"] / "bundle"), port=0)


def test_handler_runs_the_device_under_inference_mode(setup):
    """Handler threads start with grad mode on; predict and the argmax
    must still run under inference mode, and no autograd Function may
    run (on the card each would cost host time and keep activations)."""
    service = setup["server"].RequestHandlerClass.service
    seen, applied = [], []
    predict = service.served.predict
    function_apply = torch.autograd.Function.__dict__["apply"]

    def watched(*args, **kwargs):
        out = predict(*args, **kwargs)
        seen.append((threading.current_thread() is not threading.main_thread(),
                     torch.is_inference_mode_enabled(), out.requires_grad))
        return out

    def counting(cls, *args, **kwargs):
        applied.append(cls.__name__)
        return function_apply.__func__(cls, *args, **kwargs)

    service.served.predict = watched
    torch.autograd.Function.apply = classmethod(counting)
    try:
        status, _, _ = post(f"{setup['url']}/predict?modality=0", setup["scan"].read_bytes())
    finally:
        torch.autograd.Function.apply = function_apply
        del service.served.predict
    assert status == 200
    assert seen == [(True, True, False)]
    assert applied == []


def test_http_predict_through_baked_volume_program(setup, tmp_path):
    """The counterpart of JAX's test of this name: a bundle exported with
    the scan's preprocessed shape (39 x 32 x 32) as a volume program and
    `bake_params`; the scan's request must run that program (the baked
    window program inside it), and /health must say so.  Its labels equal
    the window path's answer from the module's server wherever that
    server's top-two logits differ by more than 1e-4 (the two paths agree
    at 1e-5, tests/test_torch_export.py)."""
    service = setup["server"].RequestHandlerClass.service
    weights = torch.load(setup["root"] / "bundle" / "weights.pt", weights_only=True)
    bundle = export_bundle(Config(**CFG), weights, tmp_path / "bundle", platforms=("cpu",),
                           volume_shapes=[(39, 32, 32)], bake_params=True)
    server = S.make_server(str(bundle), port=0, device="cpu")
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_port}"
        raw = setup["scan"].read_bytes()
        status, _, out = post(f"{url}/predict?modality=1", raw)
        assert status == 200
        baked = server.RequestHandlerClass.service.served
        prog = baked.volume_program((39, 32, 32))
        assert prog is not None and prog.calls == 1
        # the server's warm-up window alone: the request ran no window outside the program
        assert baked.window_graph.calls == 1
        assert baked.meta["volume_programs"][0]["params_baked"]
        assert baked.form == "baked"
        with urllib.request.urlopen(f"{url}/health") as r:
            health = json.loads(r.read())
        assert health["volume_programs_loaded"] == ["39x32x32"]
        assert health["window_form"] == "baked"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=30)
    _, _, want = post(f"{setup['url']}/predict?modality=1", raw)
    sample = service.preprocess(raw)
    logits = service.served.predict(torch.from_numpy(sample["image"][None]), [1]).numpy()
    top2 = np.sort(logits[0], axis=-1)[..., -2:]
    decisive = (top2[..., 1] - top2[..., 0] > 1e-4).astype(np.float32)
    mask = service.chain.inverse({**sample, "label": decisive[..., None]}, key="label")["label"]
    keep = mask > 0.5
    assert keep.mean() > 0.9
    got, ref = as_nifti(tmp_path, out, "baked.nii.gz"), as_nifti(tmp_path, want, "arg.nii.gz")
    assert np.array_equal(got.affine, ref.affine)
    assert np.array_equal(got.data[keep], ref.data[keep])
