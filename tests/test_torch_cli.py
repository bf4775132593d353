"""The port's entry points on the CPU: `cli.predict_whs.main` against the
JAX package's `main` over a two-scan synthetic datalist, `cli.export.main`
(checkpoint -> bundle, the bundle's forward against the live model), the
checkpoint format, and the command line generated from `Config`: the
same flags and defaults as JAX's, any JAX config converting, the same
argv (a JAX `tune` command line among them) parsing to equal configs,
`--no_gpu` as `--device cpu`, every field whose feature is not ported
raising `NotImplementedError` at its entry point (`Trainer`) unless it
holds JAX's default, and JAX's export options (platforms, volume
programs, baked weights) exporting bundles that pass `--export_check`.

Model: `swin_unetr` at feature_size 12, 32^3 ROI, f32, 4 classes, JAX
parameters seeded from numpy, saved as a JAX checkpoint for JAX's `main`
and, through `weights.state_dict_from_jax`, as a port checkpoint for the
port's.  Logits (constant blend) agree at atol 5e-4 and labels wherever
JAX's top two logits differ by more than that: on preprocessed scans
JAX's own f32 logits sit ~1e-4 from float64 (see
`test_torch_serve_http.py`).  Affines and file names are exact.
"""

import dataclasses
import functools
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bridge import seeded_params
from test_torch_serve_http import CFG, write_scan

from miseg_tpu.cli import predict_whs as jax_predict_whs
from miseg_tpu.config import Config as JConfig
from miseg_tpu.config import build_parser as jax_build_parser
from miseg_tpu.models import model_from_config as jax_model_from_config
from miseg_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from miseg_tpu.train.engine import Trainer as JTrainer
from miseg_tpu_torch import config
from miseg_tpu_torch.cli import export, parse_args, predict_whs
from miseg_tpu_torch.config import Config, build_parser, parse_config
from miseg_tpu_torch.data.multi_modal import eval_transforms
from miseg_tpu_torch.data.nifti import load_nifti
from miseg_tpu_torch.models import model_from_config
from miseg_tpu_torch.serve import load_bundle
from miseg_tpu_torch.train import checkpoint as ckpt
from miseg_tpu_torch.train.engine import Trainer
from miseg_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(1)
ATOL_SCAN = 5e-4


@pytest.fixture(scope="module")
def params():
    jmodel = jax_model_from_config(JConfig(**CFG))
    return seeded_params(jmodel, jnp.zeros((1, 32, 32, 32, 1)), jnp.zeros((1,), jnp.int32),
                         seed=3)


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    """Two CT scans (LPS int16, RAS float32) whose preprocessed grids are
    both 40 x 30 x 28, in a decathlon datalist with a "test" split."""
    root = tmp_path_factory.mktemp("whs")
    (root / "ct").mkdir()
    write_scan(root / "ct" / "a_image.nii.gz", (40, 30, 28), (1.0, 1.0, 1.0), seed=8,
               dtype=np.int16)
    write_scan(root / "ct" / "b_image.nii.gz", (32, 24, 20), (1.25, 1.25, 1.4), seed=9,
               lps=False)
    (root / "CT_test.json").write_text(json.dumps(
        {"modality": 0, "test": ["ct/a_image.nii.gz", "ct/b_image.nii.gz"]}))
    return root


def _capture_inferer_outputs(monkeypatch, trainer_cls, sink: list):
    """Record every volume's logits from `trainer_cls.make_inferer`'s
    inferer, unchanged."""
    make = trainer_cls.make_inferer

    def make_inferer(self, mode="constant"):
        inferer = make(self, mode)

        def call(*args, **kwargs):
            out = inferer(*args, **kwargs)
            sink.append(np.asarray(out))
            return out
        return call

    monkeypatch.setattr(trainer_cls, "make_inferer", make_inferer)


def test_predict_whs_matches_jax(params, dataset, tmp_path, monkeypatch):
    jax_ckpt, port_ckpt = tmp_path / "jax.ckpt", tmp_path / "port.pt"
    jax_save_checkpoint(jax_ckpt, params=params)
    ckpt.save_checkpoint(port_ckpt, params=state_dict_from_jax(params))
    jax_logits, port_logits = [], []
    _capture_inferer_outputs(monkeypatch, JTrainer, jax_logits)
    _capture_inferer_outputs(monkeypatch, Trainer, port_logits)
    # JAX's main initialises a model with flax before it loads the
    # checkpoint over every parameter; start it from the same parameters
    # instead (the init is ~35 s of eager flax on a CPU, and is overwritten)
    init = JTrainer.init_state
    monkeypatch.setattr(JTrainer, "init_state",
                        lambda self, img, mods, rng=None, **kw: init(self, img, mods,
                                                                     params=params))
    common = dict(data_dir=str(dataset), json_list="CT_test.json")
    want = jax_predict_whs.main(
        JConfig(**CFG, ckpt_path=str(jax_ckpt), default_root_dir=str(tmp_path / "jax")),
        result_dir=str(tmp_path / "jax_out"), **common)
    got = predict_whs.main(
        Config(**CFG, ckpt_path=str(port_ckpt), default_root_dir=str(tmp_path / "port")),
        result_dir=str(tmp_path / "port_out"), device="cpu", **common)
    assert [os.path.basename(p) for p in got] == [os.path.basename(p) for p in want] == [
        "a_label.nii.gz", "b_label.nii.gz"]
    assert len(jax_logits) == len(port_logits) == 2
    tr = eval_transforms(Config(**CFG), allow_missing_keys=True)
    for ours_path, theirs_path, jl, pl, name in zip(got, want, jax_logits, port_logits,
                                                     ("a", "b")):
        assert pl.shape == jl.shape == (1, 40, 32, 32, 4)
        assert np.abs(pl - jl).max() <= ATOL_SCAN
        ours, theirs = load_nifti(ours_path), load_nifti(theirs_path)
        scan = load_nifti(dataset / "ct" / f"{name}_image.nii.gz")
        assert ours.data.shape == theirs.data.shape == scan.data.shape
        assert ours.data.dtype == np.uint16
        assert np.array_equal(ours.affine, scan.affine)
        assert np.array_equal(ours.affine, theirs.affine)
        top2 = np.sort(jl[0], axis=-1)[..., -2:]
        decisive = (top2[..., 1] - top2[..., 0] > ATOL_SCAN).astype(np.float32)
        path = str(dataset / "ct" / f"{name}_image.nii.gz")
        sample = tr({"image": path, "label": path})
        keep = tr.inverse({**sample, "label": decisive[..., None]}, key="label")["label"] > 0.5
        assert keep.mean() > 0.9
        assert np.array_equal(ours.data[keep], theirs.data[keep])
        assert set(np.unique(ours.data)) <= {0, 500, 600, 420}


def test_make_inferer_runs_the_compute_dtype(params):
    """The inferer runs `apply_fn` (bf16 under amp, f32 logits) under
    inference mode, one cached inferer per blend mode."""
    trainer = Trainer(Config(**{**CFG, "no_amp": False, "precision": "bf16"}), device="cpu")
    trainer.init_state(state_dict_from_jax(params))
    inferer = trainer.make_inferer()
    assert inferer is trainer.make_inferer() and inferer is not trainer.make_inferer("gaussian")
    x = torch.from_numpy(np.random.default_rng(0).random((1, 32, 32, 32, 1), np.float32))
    out = inferer(x, torch.tensor([0], dtype=torch.int32))
    assert out.dtype == torch.float32 and not out.requires_grad and out.is_inference()
    with torch.no_grad():
        want = trainer.apply_fn(dict(trainer.model.named_parameters()), x,
                                torch.tensor([0], dtype=torch.int32))
    assert torch.equal(out, want)


def test_checkpoint_round_trip(tmp_path):
    model = model_from_config(Config(**CFG), device="cpu")
    opt = torch.optim.AdamW(model.parameters(), lr=1e-3)
    model(torch.rand(1, 32, 32, 32, 1), torch.tensor([0], dtype=torch.int32)).sum().backward()
    opt.step()
    path = tmp_path / "c" / "last.pt"
    ckpt.save_checkpoint(path, params=model.state_dict(), opt_state=opt.state_dict(),
                         epoch=7, best_acc=0.625, scheduler_state={"step": 3},
                         extra={"note": "x"})
    back = ckpt.load_checkpoint(path)
    assert back["epoch"] == 7 and back["best_acc"] == 0.625
    assert back["scheduler"] == {"step": 3} and back["extra"] == {"note": "x"}
    assert back["params"].keys() == model.state_dict().keys()
    assert all(torch.equal(back["params"][k], v) for k, v in model.state_dict().items())
    opt2 = torch.optim.AdamW(model.parameters(), lr=1e-3)
    opt2.load_state_dict(back["opt_state"])
    assert opt2.state_dict()["state"].keys() == opt.state_dict()["state"].keys()
    state = opt.state_dict()["state"][0]
    assert torch.equal(opt2.state_dict()["state"][0]["exp_avg"], state["exp_avg"])
    no_opt = tmp_path / "p.pt"
    ckpt.save_checkpoint(no_opt, params=model.state_dict())
    assert ckpt.load_checkpoint(no_opt)["opt_state"] is None


def test_partial_load_skips_other_heads(tmp_path, capsys):
    """A checkpoint of a 3-class model loads into a 4-class one but for
    the output head, which keeps its initial weights and is reported."""
    small = model_from_config(Config(**{**CFG, "out_channels": 3, "seed": 1}), device="cpu")
    target = model_from_config(Config(**CFG), device="cpu").state_dict()
    path = tmp_path / "three.pt"
    ckpt.save_checkpoint(path, params=small.state_dict())
    merged = ckpt.load_any_checkpoint_params(path, target, model_name=CFG["model_name"])
    heads = [k for k in target if small.state_dict()[k].shape != target[k].shape]
    assert heads and all(k.startswith("out.") for k in heads)
    for k, v in merged.items():
        want = target[k] if k in heads else small.state_dict()[k]
        assert torch.equal(v, want) and v.dtype == target[k].dtype
    assert "shape-skipped" in capsys.readouterr().out


def test_foreign_checkpoints_raise_naming_m8(params, tmp_path):
    """`load_checkpoint` reads the port's own format only; for the JAX
    package's and the reference's files it names the ingest that reads
    them (the checkpoint ingest once planned as ROADMAP M8)."""
    jax_path = tmp_path / "jax.ckpt"
    jax_save_checkpoint(jax_path, params=params)
    torch_path = tmp_path / "reference.pt"
    torch.save({"state_dict": {"w": torch.zeros(2)}, "epoch": 1}, torch_path)
    for path in (jax_path, torch_path):
        with pytest.raises(ValueError, match="load_any_checkpoint_params"):
            ckpt.load_checkpoint(path)


def test_export_then_bundle_forward_equals_live(params, tmp_path):
    path = tmp_path / "best.pt"
    ckpt.save_checkpoint(path, params=state_dict_from_jax(params))
    cfg = Config(**{**CFG, "space_x": 1.5}, ckpt_path=str(path),
                 export_dir=str(tmp_path / "bundle"), export_check=True)
    out = export.main(cfg, device="cpu")
    served = load_bundle(out, device="cpu")
    assert served.meta["spacing"] == [1.5, 1.0, 1.0] and served.meta["bundle_version"] == 3
    live = model_from_config(cfg, device="cpu")
    live.load_state_dict(state_dict_from_jax(params))
    x = np.random.default_rng(1).random((1, 32, 32, 32, 1), np.float32)
    mods = np.array([1], np.int32)
    with torch.inference_mode():
        want = live(torch.from_numpy(x), torch.from_numpy(mods)).numpy()
    assert np.abs(served(x, mods).numpy() - want).max() <= 1e-6
    with pytest.raises(ValueError, match="ckpt_path"):
        export.main(Config(**CFG), device="cpu")


def test_entry_points_need_a_card_unless_asked_for_the_cpu(params, dataset, tmp_path,
                                                          monkeypatch):
    path = tmp_path / "best.pt"
    ckpt.save_checkpoint(path, params=state_dict_from_jax(params))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        predict_whs.main(Config(**CFG, ckpt_path=str(path)), data_dir=str(dataset),
                         json_list="CT_test.json", result_dir=str(tmp_path / "out"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export.main(Config(**CFG, ckpt_path=str(path), export_dir=str(tmp_path / "b")))


def test_command_line_matches_jax_flags():
    """The port's command line has exactly the JAX package's flags with the
    same defaults, the generated parser reads lists, bools, None-typed and
    float fields as JAX's does, and any JAX config converts."""
    ours = {a.dest: a.default for a in build_parser()._actions if a.dest != "help"}
    theirs = {a.dest: a.default for a in jax_build_parser()._actions if a.dest != "help"}
    assert ours.keys() == theirs.keys()
    assert ours == theirs
    assert dataclasses.asdict(Config(**dataclasses.asdict(JConfig()))) == dataclasses.asdict(
        JConfig())
    assert Config() == Config(**dataclasses.asdict(JConfig()))
    argv = ["--model_name", "swin_unetr", "--feature_size", "48", "--space_x", "1.5",
            "--json_lists", "CT_test.json", "--ckpt_path", "best.pt", "--export_check",
            "--no_amp"]
    cfg = parse_config(argv)
    assert cfg.feature_size == [48] and cfg.spacing == (1.5, 1.0, 1.0)
    assert cfg.json_lists == ["CT_test.json"] and cfg.ckpt_path == "best.pt"
    assert cfg.export_check and not cfg.amp
    jcfg = JConfig(**{k: v for k, v in vars(jax_build_parser().parse_args(argv)).items()})
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    cfg2, device = parse_args(argv + ["--device", "cpu"])
    assert cfg2 == cfg and device == "cpu"
    assert cfg.replace(seed=4).seed == 4 and Config.from_args(
        build_parser().parse_args(argv)) == cfg


def test_jax_tune_command_line_parses_alike():
    """A JAX `tune` command line (the reference's tune group) parses to an
    equal config in both packages, and the port's converts to JAX's."""
    argv = ["--model_name", "swin_unetr", "--n_trials", "40", "--timeout", "3600",
            "--storage_name", "study-db", "--port", "29500", "--no_gpu", "--source", "1",
            "--study_name", "swin", "--mesh_shape", "1", "--export_platforms", "cpu"]
    cfg = parse_config(argv)
    jcfg = JConfig(**vars(jax_build_parser().parse_args(argv)))
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    assert (cfg.n_trials, cfg.timeout, cfg.storage_name, cfg.port, cfg.no_gpu,
            cfg.source) == (40, 3600, "study-db", "29500", True, 1)
    assert dataclasses.asdict(JConfig(**dataclasses.asdict(cfg))) == dataclasses.asdict(cfg)


def test_no_gpu_selects_the_cpu(monkeypatch):
    """`--no_gpu` is `--device cpu`; beside a CUDA device it raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, device = parse_args(["--no_gpu"])
    assert cfg.no_gpu and device == "cpu"
    assert parse_args(["--no_gpu", "--device", "cpu"])[1] == "cpu"
    with pytest.raises(ValueError, match="no_gpu"):
        parse_args(["--no_gpu", "--device", "cuda"])
    with pytest.raises(ValueError, match="no_gpu"):
        parse_args(["--no_gpu", "--device", "cuda:0"])
    assert parse_args([])[1] is None   # the card, resolved by the entry point
    trainer = Trainer(Config(**CFG, no_gpu=True))
    assert trainer.device == torch.device("cpu")
    with pytest.raises(ValueError, match="no_gpu"):
        Trainer(Config(**CFG, no_gpu=True), device="cuda")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(Config(**CFG))


# a value other than JAX's default for every parallelism field, and for
# the mesh: a shape whose product is not the world size, an axis no mode
# claims
MESH_VALUES = {"mesh_shape": [2], "mesh_axes": ["sp"]}
PARALLEL_VALUES = {
    "fsdp": True, "fsdp_axis": "fsdp",
    "fsdp_min_size": 1024, "spatial_shard": True, "spatial_axis": "space",
    "tensor_parallel": True, "tp_axis": "tp", "pipeline_parallel": True, "pp_axis": "stage",
    "pp_microbatches": 4,
}
# those of the spatial mode, ported last
SPATIAL_VALUES = {k: v for k, v in PARALLEL_VALUES.items() if k.startswith("spatial")}


def test_not_ported_fields_cover_jax_defaults():
    """No field is left unported (the config has no list of them any
    more): the export options, the mesh, FSDP, tensor, pipeline and
    spatial parallelism all are; every field keeps JAX's name and default,
    and the values above differ from the spatial fields'."""
    jax_defaults = dataclasses.asdict(JConfig())
    assert not hasattr(config, "NOT_PORTED")
    defaults = dataclasses.asdict(Config())
    assert defaults == jax_defaults
    assert sorted(SPATIAL_VALUES) == ["spatial_axis", "spatial_shard"]
    assert all(defaults[k] == jax_defaults[k] != v for k, v in SPATIAL_VALUES.items())


@pytest.mark.parametrize("field", sorted([*PARALLEL_VALUES, *MESH_VALUES]))
def test_trainer_raises_on_parallelism(field):
    """No parallelism field raises at one process now: a mesh whose
    product is not the world size raises ValueError (JAX's `make_mesh`);
    an axis no mode claims (a spatial one without `spatial_shard`) builds
    and, one rank, steps as data parallelism does, as JAX's one device
    does; the FSDP and tensor-parallel fields build and, their axes of
    size 1, place nothing; the pipeline and spatial fields build and, with
    no pipeline or spatial line of more than one rank, take the
    data-parallel step (JAX's `_pp_active` and SP rule)."""
    value = {**PARALLEL_VALUES, **MESH_VALUES}[field]
    cfg = Config(**CFG, **{field: value})
    if field == "mesh_shape":
        with pytest.raises(ValueError, match=r"mesh shape \[2\] != 1 ranks"):
            Trainer(cfg, device="cpu")
    else:
        trainer = Trainer(cfg, device="cpu")
        state = trainer.init_state()
        assert trainer.placements == {}
        if field in ("pipeline_parallel", "pp_axis", "pp_microbatches", "mesh_axes",
                     *SPATIAL_VALUES):
            assert not trainer._pp_active() and trainer._sp_size() == 1
            _, loss = trainer.train_step(state, _parallel_batch())
            assert torch.equal(loss, _data_parallel_loss())


def _parallel_batch() -> dict:
    rng = np.random.default_rng(4)
    return {"image": rng.standard_normal((1, 32, 32, 32, 1)).astype(np.float32),
            "label": rng.integers(0, CFG["out_channels"], (1, 32, 32, 32)).astype(np.int32),
            "modality": np.array([1], np.int32)}


@functools.lru_cache(maxsize=None)
def _data_parallel_loss() -> torch.Tensor:
    """The loss of one step of `CFG` as it is, on `_parallel_batch()`."""
    trainer = Trainer(Config(**CFG), device="cpu")
    return trainer.train_step(trainer.init_state(), _parallel_batch())[1]


def test_trainer_takes_jax_parallelism_defaults():
    """JAX's defaults, and a one-device mesh, build the trainer."""
    for mesh in ([-1], [1]):
        cfg = Config(**{**CFG, "mesh_shape": mesh})
        assert Trainer(cfg, device="cpu").device == torch.device("cpu")


# JAX's three export options at values other than their defaults, and
# what each adds to the bundle's meta
EXPORT_OPTIONS = {
    "export_platforms": (["cpu"], {"platforms": ["cpu"]}),
    "export_volume_shapes": (["40x36x32"], {"volume_programs": [{
        "tag": "40x36x32", "spatial": [40, 36, 32], "batch": 1, "mode": "gaussian",
        "overlap": 0.5, "params_baked": False}]}),
    "export_bake_params": (True, {"window_baked": True}),
}


@pytest.mark.parametrize("field", sorted(EXPORT_OPTIONS))
def test_export_takes_jax_export_options(params, tmp_path, field, capsys):
    """Each of JAX's export options exports as JAX's does, and the bundle
    passes `--export_check` (its window programs against the live model,
    its volume programs against the generic inferer)."""
    path = tmp_path / "best.pt"
    ckpt.save_checkpoint(path, params=state_dict_from_jax(params))
    value, meta = EXPORT_OPTIONS[field]
    cfg = Config(**CFG, ckpt_path=str(path), export_dir=str(tmp_path / "bundle"),
                 export_check=True, **{field: value})
    out = export.main(cfg, device="cpu")
    got = json.loads((tmp_path / "bundle" / "meta.json").read_text())
    assert {k: got[k] for k in meta} == meta
    assert (tmp_path / "bundle" / "window_fn_baked.pt2").exists() == (
        field == "export_bake_params")
    said = capsys.readouterr().out
    forms = 2 if field == "export_bake_params" else 1
    assert said.count("export check ok on cpu") == forms + (field == "export_volume_shapes")
    assert load_bundle(out, "cpu").meta == got
    if field == "export_volume_shapes":
        with pytest.raises(ValueError, match="must be 3 positive integers joined by 'x'"):
            export.main(cfg.replace(export_volume_shapes=["40x36"]), device="cpu")
