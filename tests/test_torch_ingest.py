"""Weights from elsewhere, in the port against the JAX package (CPU, f32):
MONAI's Swin-ViT (`train/pretrained.py`), the reference's own `.pt`/`.ckpt`
files (`train/ref_import.py`) and the JAX package's msgpack checkpoints
(`train/flax_msgpack.py`, `train/checkpoint.py`).

* Swin-ViT: a MONAI-layout `model_swinvit.pt` written here from a seed
  (`module.` prefix, `layersK.0.blocks.J`, `fc1`/`fc2`, a wrong-shaped
  entry, position indices and a head the backbone lacks), for `layer`
  and `instance_cond` ViT norms: every tensor of the port's load equals
  `state_dict_from_jax` of JAX's `load_swin_vit_torch` exactly, with the
  same loaded and shape-skipped names; `pre_swin_unetr` logits within
  2e-4 of JAX's; `cli.train --pre_swin` from a command line, and the
  error without it, as JAX's.
* The reference's files, all five model names: state dicts in the
  reference's naming made here from a seed (the inverse of the grammar,
  written out in `to_reference`).  The port's `reference_state_dict`
  gives back the seeded tensors and equals `state_dict_from_jax` of the
  JAX package's `ref_import.reference_to_flax` exactly (UNetVanilla: of
  `torch_import`, since `ref_import` has no grammar for it); the logits
  of the four architectures within 2e-4 of JAX's on those parameters.
  The Lightning `model.` and DDP `module.` prefixes, `fc1`/`fc2`, batch
  norm's running statistics, and an output head of another size kept at
  init.
* W10: JAX's two translators disagree on every transposed kernel (one is
  the other spatially reversed); only `ref_import`'s gives JAX logits
  equal to the port's.
* JAX msgpack checkpoints written by `miseg_tpu.train.checkpoint` with
  an AdamW `opt_state`: the port's decoder equals
  `flax.serialization.msgpack_restore` leaf for leaf (f32, bf16 leaves,
  numpy scalars, chunked arrays; also with `msgpack` unimportable); the
  loaded parameters equal the bridged ones exactly; `cli.test` on a JAX
  `best.ckpt` gives JAX `cli.test`'s metrics within 1e-4; a batch-norm
  file leaves the running statistics at 0 and 1 and says so (W9); a
  garbage file raises naming the three formats.
"""

import functools
import importlib
import re
import sys
import types

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_bridge import max_err, seeded_params, t

from miseg_tpu.cli import test as jax_cli_test
from miseg_tpu.config import Config as JConfig
from miseg_tpu.models import model_from_config as jax_model_from_config
from miseg_tpu.train import pretrained as jax_pretrained
from miseg_tpu.train import ref_import as jax_ref_import
from miseg_tpu.train import torch_import as jax_torch_import
from miseg_tpu.train.checkpoint import save_checkpoint as jax_save_checkpoint
from miseg_tpu.train.engine import Trainer as JTrainer
from miseg_tpu_torch import weights
from miseg_tpu_torch.cli import parse_args
from miseg_tpu_torch.cli import test as cli_test
from miseg_tpu_torch.cli import train as cli_train
from miseg_tpu_torch.config import Config
from miseg_tpu_torch.data.synthetic import make_synthetic_dataset
from miseg_tpu_torch.models import model_from_config
from miseg_tpu_torch.train import checkpoint as ckpt
from miseg_tpu_torch.train import flax_msgpack
from miseg_tpu_torch.train.engine import Trainer
from miseg_tpu_torch.train.pretrained import (load_report, load_swin_vit_torch,
                                              read_torch_file, swin_vit_state_dict)
from miseg_tpu_torch.train.ref_import import load_reference_checkpoint, reference_state_dict
from miseg_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(1)
ATOL_MODEL = 2e-4
ATOL_METRIC = 1e-4
SWIN = dict(model_name="swin_unetr", out_channels=4, feature_size=[12], num_heads=2,
            roi_x=32, roi_y=32, roi_z=32, encoder_norm_name="instance_cond",
            vit_norm_name="instance_cond", decoder_norm_name="instance")
MODELS = {
    "swin_unetr": SWIN,
    "pre_swin_unetr": dict(SWIN, model_name="pre_swin_unetr"),
    "unetr": dict(model_name="unetr", out_channels=4, feature_size=[8], hidden_size=48,
                  mlp_dim=96, num_heads=4, roi_x=32, roi_y=32, roi_z=32,
                  encoder_norm_name="instance_cond", vit_norm_name="instance_cond"),
    "unet": dict(model_name="unet", out_channels=4, feature_size=[4], roi_x=16, roi_y=16,
                 roi_z=16, encoder_norm_name="instance_cond"),
    "unet_vanilla": dict(model_name="unet_vanilla", out_channels=4, feature_size=[4, 8, 16],
                         strides=[1, 2, 2], roi_x=16, roi_y=16, roi_z=16,
                         encoder_norm_name="instance_cond"),
}


@functools.lru_cache(maxsize=None)
def _jax_case(name: str):
    """(JAX model, input, modalities, seeded params) of a model, once a worker."""
    cfg = MODELS[name]
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, cfg["roi_x"], cfg["roi_y"], cfg["roi_z"], 1)).astype(np.float32)
    mods = np.array([0, 1], np.int32)
    jmodel = jax_model_from_config(JConfig(**cfg))
    return jmodel, x, mods, seeded_params(jmodel, jnp.asarray(x), jnp.asarray(mods), seed=5)


def _jax_logits(name: str, params) -> np.ndarray:
    jmodel, x, mods, _ = _jax_case(name)
    return np.asarray(jax.jit(lambda p: jmodel.apply({"params": p}, x, mods))(params))


def _port_logits(name: str, state_dict) -> torch.Tensor:
    _, x, mods, _ = _jax_case(name)
    model = model_from_config(Config(**MODELS[name]), device="cpu")
    model.load_state_dict(state_dict, strict=True)
    with torch.no_grad():
        return model(t(x), t(mods))


def _same(a: dict, b: dict) -> None:
    assert a.keys() == b.keys(), (sorted(set(a) ^ set(b)))[:6]
    for k in a:
        assert a[k].dtype == b[k].dtype and torch.equal(a[k], b[k]), k


# ----------------------------------------------------------- Swin-ViT ----

def _seeded(key: str, shape, rng) -> np.ndarray:
    """`seeded_params`' scales, in torch layouts: weights ~ N(0, 1/fan_in),
    norm weights ~ 1 + N(0, 0.1^2), rel-pos tables ~ N(0, 0.02^2), biases
    ~ N(0, 0.1^2)."""
    v = rng.standard_normal(shape)
    if key.endswith("relative_position_bias_table"):
        return (0.02 * v).astype(np.float32)
    if key.endswith("weight") and len(shape) >= 2:
        return (v / np.sqrt(np.prod(shape[1:]))).astype(np.float32)
    if key.endswith("weight"):
        return (1.0 + 0.1 * v).astype(np.float32)
    return (0.1 * v).astype(np.float32)


def monai_swin_vit(port_swin: dict, rng) -> dict:
    """A MONAI `model_swinvit.pt` state dict with seeded values for a port
    `swinViT` (names relative to it): `module.` prefix, `layersK.0.blocks.J`,
    `fc1`/`fc2`, `[C]` LayerNorm rows (a bank's width), torch layouts; plus
    position indices, a head the backbone lacks and one wrong-shaped entry."""
    sd = {}
    for name, v in port_swin.items():
        key = re.sub(r"(layers\d+)\.", r"\1.0.", name)
        key = re.sub(r"blocks_(\d+)", r"blocks.\1", key)
        key = key.replace("linear1", "fc1").replace("linear2", "fc2").replace(".scale", ".weight")
        shape = v.shape[-1:] if (name.endswith((".scale", ".bias")) and v.ndim == 2) else v.shape
        sd["module." + key] = torch.from_numpy(_seeded(key, shape, rng))
        if key.endswith("attn.qkv.weight"):
            sd["module." + key.replace("qkv.weight", "relative_position_index")] = torch.zeros(
                8, dtype=torch.int64)
    sd["module.rotation_head.weight"] = torch.ones(4, 8)
    sd["module.layers2.0.blocks.0.attn.qkv.weight"] = torch.ones(5, 5)
    return sd


@pytest.mark.parametrize("vit_norm", ["layer", "instance_cond"])
def test_swin_vit_ingest_matches_jax(tmp_path, vit_norm, monkeypatch, capsys):
    cfg = dict(MODELS["pre_swin_unetr"], vit_norm_name=vit_norm)
    jmodel = jax_model_from_config(JConfig(**cfg))
    x = jnp.zeros((1, 32, 32, 32, 1))
    params = seeded_params(jmodel, x, jnp.zeros((1,), jnp.int32), seed=6)
    port = state_dict_from_jax(params)
    swin = {k[len("swinViT."):]: v for k, v in port.items() if k.startswith("swinViT.")}
    path = tmp_path / "model_swinvit.pt"
    torch.save({"state_dict": monai_swin_vit(swin, np.random.default_rng(7))}, path)

    seen = {}
    partial = jax_pretrained.partial_load

    def spy(target, source, *, verbose=True):
        tf, sf = jax_pretrained._flatten(target), jax_pretrained._flatten(source)

        def name(p):
            return ".".join((*p[:-1], "weight" if p[-1] == "kernel" else p[-1]))

        seen["loaded"] = sorted(name(p) for p in tf if p in sf
                                and np.shape(sf[p]) == np.shape(tf[p]))
        seen["skipped"] = sorted(name(p) for p in tf if p in sf
                                 and np.shape(sf[p]) != np.shape(tf[p]))
        return partial(target, source, verbose=verbose)

    monkeypatch.setattr(jax_pretrained, "partial_load", spy)
    want = state_dict_from_jax(jax_pretrained.load_swin_vit_torch(str(path), params))
    got = load_swin_vit_torch(path, port)
    _same(got, want)
    report = load_report(swin, swin_vit_state_dict(read_torch_file(path)))
    assert sorted(report["loaded"]) == seen["loaded"]
    assert sorted(n for n, _, _ in report["skipped"]) == seen["skipped"]
    norms = [n for n in swin if re.search(r"norm\d?\.(scale|bias)$", n)]
    if vit_norm == "layer":
        assert seen["skipped"] == ["layers2.blocks_0.attn.qkv.weight"]
    else:   # the [C] rows do not fit the [2, C] banks
        assert seen["skipped"] == sorted(norms + ["layers2.blocks_0.attn.qkv.weight"])
    assert len(seen["loaded"]) == len(swin) - len(seen["skipped"])
    assert report["missing"] == report["unexpected"] == []   # the head is not the backbone's
    assert all(torch.equal(got[k], port[k]) for k in port if not k.startswith("swinViT."))
    out = capsys.readouterr().out
    assert out.count(f"shape-skipped {len(seen['skipped'])},") == 2   # both packages' reports

    # the whole model on those weights: pre_swin_unetr logits as JAX's
    rng = np.random.default_rng(8)
    xs = rng.standard_normal((2, 32, 32, 32, 1)).astype(np.float32)
    mods = np.array([0, 1], np.int32)
    jp = jax_pretrained.load_swin_vit_torch(str(path), params, verbose=False)
    ref = np.asarray(jax.jit(lambda p: jmodel.apply({"params": p}, xs, mods))(jp))
    model = model_from_config(Config(**cfg), device="cpu")
    model.load_state_dict(got, strict=True)
    with torch.no_grad():
        err = max_err(model(t(xs), t(mods)), ref)
    print(f"pre_swin_unetr ({vit_norm}) logits max |port - jax| = {err:.3e}")
    assert err <= ATOL_MODEL


@pytest.fixture(scope="module")
def dataset(tmp_path_factory):
    root = tmp_path_factory.mktemp("ingestdata")
    make_synthetic_dataset(root, shape=(32, 32, 32), num_classes=4, n_train=1, n_val=1,
                           n_test=1, spacing=(1.0, 1.0, 1.0), seed=6)
    return root


def test_cli_train_pre_swin_from_a_command_line(dataset, tmp_path, monkeypatch, capsys):
    swin = {k[len("swinViT."):]: v for k, v in model_from_config(
        Config(**MODELS["pre_swin_unetr"]), device="cpu").state_dict().items()
        if k.startswith("swinViT.")}
    path = tmp_path / "model_swinvit.pt"
    torch.save(monai_swin_vit(swin, np.random.default_rng(9)), path)
    argv = ["--model_name", "pre_swin_unetr", "--out_channels", "4", "--feature_size", "12",
            "--num_heads", "2", "--roi_x", "32", "--roi_y", "32", "--roi_z", "32",
            "--encoder_norm_name", "instance_cond", "--vit_norm_name", "instance_cond",
            "--no_amp", "--max_epochs", "1", "--num_workers", "0", "--cache_num", "2",
            "--use_checkpoint", "--data_dirs", str(dataset), str(dataset),
            "--json_lists", "CT.json", "MR.json", "--default_root_dir", str(tmp_path),
            "--experiment_name", "run", "--device", "cpu"]
    monkeypatch.setattr(sys, "argv", ["train", *argv, "--pre_swin", str(path)])
    trainer, state, metrics = cli_train.main()
    assert trainer.cfg.use_checkpoint and state.step == 2
    assert "Loaded pre-trained Swin-ViT" in capsys.readouterr().out
    assert np.isfinite(metrics["test/loss/avg"])
    # without --pre_swin: JAX's error, from the port and from JAX's own Trainer
    cfg, _ = parse_args(argv)
    with pytest.raises(ValueError, match="pre_swin_unetr requires --pre_swin") as ours:
        Trainer(cfg, device="cpu").fresh_state()
    with pytest.raises(ValueError) as theirs:
        JTrainer.apply_pretrained(types.SimpleNamespace(cfg=JConfig(**cfg.to_dict())),
                                  types.SimpleNamespace(params={}))
    assert str(ours.value) == str(theirs.value)


# ------------------------------------------------ the reference's files ----

def to_reference(model_name: str, sd: dict) -> dict:
    """A port state dict in the reference's naming (what its nets'
    `state_dict()` holds): the inverse of `reference_state_dict`, written
    out per rule, with the entries the port drops added."""
    out = {}
    for name, v in sd.items():
        *path, leaf = name.split(".")
        toks = []
        for i, p in enumerate(path):
            if re.fullmatch(r"layers\d+", p):
                toks += [p, "0"]
            elif m := re.fullmatch(r"blocks_(\d+)", p):
                toks += ["blocks", m[1]]
            elif model_name == "unetr" and (m := re.fullmatch(r"up(\d+)", p)):
                toks += ["blocks", m[1], "0"]
            elif m := re.fullmatch(r"block(\d+)", p):
                toks += ["blocks", m[1], "1"]
            elif model_name == "unetr" and p == "proj" and path[i - 1] == "attn":
                toks.append("out_proj")
            elif p == "patch_embeddings":
                toks += [p, "1"]
            elif m := re.fullmatch(r"down_path_(\d+)_(\d+)", p):
                toks += ["down_path", m[1], m[2]]
            elif m := re.fullmatch(r"up_path_(\d+)", p):
                toks += ["up_path", m[1], "1"]
            elif re.fullmatch(r"unit\d+", p):
                toks += ["conv", p]
            elif model_name == "unet" and p in ("down", "sub", "bottom", "up", "up_ru"):
                toks += {"down": ["0"], "sub": ["1", "submodule"], "bottom": ["1", "submodule"],
                         "up": ["2", "0"], "up_ru": ["2", "1"]}[p]
            else:
                toks.append(p)
        if weights._is_transposed(path[-1]) and leaf in ("weight", "bias"):
            toks.append("conv")
        base = ".".join(toks)
        if leaf in ("scale", "bias") and v.ndim == 2:       # a conditional norm's bank
            kind = "weight" if leaf == "scale" else "bias"
            out.update({f"{base}.norms.{s}.{kind}": v[s].clone() for s in range(v.shape[0])})
            continue
        leaf = {"scale": "weight", "slope": "weight", "mean": "running_mean",
                "var": "running_var"}.get(leaf, leaf)
        out[f"{base}.{leaf}"] = v
        if leaf == "running_var":
            out[f"{base}.num_batches_tracked"] = torch.tensor(3)
        if base.endswith("attn.qkv") and leaf == "weight" and "layers" in base:
            out[f"{base[:-3]}relative_position_index"] = torch.zeros(8, dtype=torch.int64)
    return out


def _reference_case(name: str):
    """(the port's seeded state dict, the same in the reference's naming)."""
    port = state_dict_from_jax(_jax_case(name)[3])
    return port, to_reference(name, port)


@pytest.mark.parametrize("name", sorted(MODELS))
def test_reference_state_dict_matches_jax(name):
    port, ref = _reference_case(name)
    got = reference_state_dict(name, ref)
    _same(got, port)
    ref_np = {k: v.numpy() for k, v in ref.items()}
    if name == "unet_vanilla":   # ref_import has no UNetVanilla grammar; torch_import has
        jax_tree = jax_torch_import.translate_reference_state_dict(ref_np)
    else:
        jax_tree = jax_ref_import.reference_to_flax(name, ref_np)
    _same(got, state_dict_from_jax(jax_tree))


@pytest.mark.parametrize("name", ["swin_unetr", "unetr", "unet", "unet_vanilla"])
def test_reference_logits_match_jax(name):
    port, ref = _reference_case(name)
    want = _jax_logits(name, _jax_case(name)[3])
    err = max_err(_port_logits(name, reference_state_dict(name, ref)), want)
    print(f"{name}: logits of the reference-named weights, max |port - jax| = {err:.3e}")
    assert err <= ATOL_MODEL


def test_reference_prefixes_renames_buffers_and_heads(tmp_path, capsys):
    port, ref = _reference_case("swin_unetr")
    # DDP's `module.` over Lightning's `model.`, fc1/fc2
    wrapped = {"module.model." + k.replace("linear1", "fc1").replace("linear2", "fc2"): v
               for k, v in ref.items()}
    assert any(".fc1." in k for k in wrapped)
    _same(reference_state_dict("swin_unetr", wrapped), port)
    # the recursive UNet's own root `model.<digit>` is kept, under Lightning's too
    uport, uref = _reference_case("unet")
    _same(reference_state_dict("unet", {"model." + k: v for k, v in uref.items()}), uport)
    _same(reference_state_dict("unet", {"module." + k: v for k, v in uref.items()}), uport)
    assert any(".submodule." in k for k in uref)
    # batch norm's running statistics land in the port's buffers
    bcfg = dict(MODELS["unet"], decoder_norm_name="batch")
    bport = model_from_config(Config(**bcfg), device="cpu").state_dict()
    rng = np.random.default_rng(3)
    bport = {k: torch.from_numpy(rng.uniform(0.5, 1.5, v.shape).astype(np.float32))
             for k, v in bport.items()}
    assert any(k.endswith(".mean") for k in bport)
    _same(reference_state_dict("unet", to_reference("unet", bport)), bport)
    # a head of another size stays at its init, and is reported
    head = {k: v for k, v in ref.items() if k.startswith("out.")}
    assert head
    small = {**ref, **{k: v[:3] for k, v in head.items()}}
    path = tmp_path / "epoch=3.ckpt"
    torch.save({"state_dict": {"model." + k: v for k, v in small.items()}, "epoch": 3,
                "hyper_parameters": {"lr": 1e-4}}, path)
    target = model_from_config(Config(**SWIN), device="cpu").state_dict()
    merged = load_reference_checkpoint(path, "swin_unetr", target)
    for k, v in merged.items():
        assert torch.equal(v, target[k] if k.startswith("out.") else port[k]), k
    assert "skipped out.conv.conv.weight" in capsys.readouterr().out
    with pytest.raises(ValueError, match="no reference naming"):
        reference_state_dict("swin_unetr_pp", ref)


def test_w10_jax_translators_disagree_on_transposed_kernels():
    """ROADMAP W10: JAX's `torch_import` loads every transposed kernel of a
    reference file spatially reversed relative to `ref_import`; only
    `ref_import`'s parameters give JAX logits equal to the port's."""
    port, ref = _reference_case("unetr")
    ref_np = {k: v.numpy() for k, v in ref.items()}
    good = jax_pretrained._flatten(jax_ref_import.reference_to_flax("unetr", ref_np))
    bad = jax_pretrained._flatten(jax_torch_import.translate_reference_state_dict(ref_np))
    assert good.keys() == bad.keys()
    transposed = [p for p in good if p[-1] == "kernel" and weights._is_transposed(p[-2])]
    assert len(transposed) == 10   # transp_conv_init x 3, up0 x 2, up1, transp_conv x 4
    for p in good:
        if p in transposed:
            assert np.array_equal(bad[p], np.flip(good[p], axis=(0, 1, 2))), p
            assert not np.array_equal(bad[p], good[p]), p
        else:
            assert np.array_equal(bad[p], good[p]), p
    ours = _port_logits("unetr", reference_state_dict("unetr", ref))
    with_ref_import = _jax_logits("unetr", jax_pretrained._unflatten(good))
    with_torch_import = _jax_logits("unetr", jax_pretrained._unflatten(bad))
    err_good, err_bad = max_err(ours, with_ref_import), max_err(ours, with_torch_import)
    print(f"unetr logits, port vs JAX on ref_import {err_good:.3e}, on torch_import {err_bad:.3e}")
    assert err_good <= ATOL_MODEL and err_bad > 100 * ATOL_MODEL


def test_w10_jax_file_reader_mangles_unet_submodules(tmp_path):
    """ROADMAP W10: the JAX package's torch-file reader
    (`pretrained._torch_state_dict`, under `ref_import.load_reference_checkpoint`)
    removes `module.` anywhere in a key, so C-UNet's `1.submodule.0...`
    arrives as `1.sub0...`; the port strips a leading `module.` only and
    loads every tensor of the same file."""
    port, ref = _reference_case("unet")
    path = tmp_path / "unet.pt"
    torch.save({"state_dict": ref, "epoch": 1}, path)
    theirs = jax_pretrained._torch_state_dict(path)
    assert not any("submodule" in k for k in theirs)
    assert any(".sub0." in k for k in theirs)
    target = model_from_config(Config(**MODELS["unet"]), device="cpu").state_dict()
    _same(load_reference_checkpoint(path, "unet", target, verbose=False), port)


# ------------------------------------------------ JAX msgpack checkpoints ----

def _leaves_equal(a, b, path=""):
    """flax's restored tree `a` against the port decoder's `b`, leaf for leaf."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and a.keys() == b.keys(), path
        for k in a:
            _leaves_equal(a[k], b[k], f"{path}/{k}")
    elif isinstance(b, torch.Tensor):   # bf16: numpy has no such dtype
        assert str(a.dtype) == "bfloat16" and b.dtype == torch.bfloat16, path
        assert np.array_equal(np.asarray(a).view(np.uint16),
                              b.view(torch.int16).numpy().view(np.uint16)), path
    else:
        assert type(a) is type(b), (path, type(a), type(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype, path
        assert np.array_equal(a, b), path


def _jax_checkpoint(path, params):
    """A JAX package checkpoint of `params` with AdamW's state after one update."""
    tx = optax.adamw(1e-3, weight_decay=1e-5)

    @jax.jit   # eager optax over a model's leaves takes tens of seconds here
    def update(p):
        return tx.update(jax.tree.map(jnp.ones_like, p), tx.init(p), p)[1]

    jax_save_checkpoint(path, params=params, opt_state=update(params), epoch=2,
                        best_acc=0.5)


def test_msgpack_decoder_matches_flax(tmp_path, monkeypatch):
    params = _jax_case("unet")[3]
    tree = {**params, "extra": {"half": jnp.asarray(np.arange(300, dtype=np.float32) / 7,
                                                    jnp.bfloat16),
                                "scalar": np.float32(2.5), "count": np.int32(7)}}
    for chunk in (None, 256):   # 256 bytes: every array above 64 f32 is chunked
        if chunk is not None:
            monkeypatch.setattr(flax.serialization, "MAX_CHUNK_SIZE", chunk)
        path = tmp_path / f"jax{chunk}.ckpt"
        _jax_checkpoint(path, tree)
        blob = path.read_bytes()
        if chunk is not None:
            assert b"__msgpack_chunked_array__" in blob
        _leaves_equal(flax.serialization.msgpack_restore(blob), flax_msgpack.msgpack_restore(blob))
    # the decoder needs no msgpack: a fresh import with msgpack unimportable
    monkeypatch.setitem(sys.modules, "msgpack", None)
    with pytest.raises(ImportError):
        import msgpack  # noqa: F401
    fresh = importlib.reload(flax_msgpack)
    _leaves_equal(flax.serialization.msgpack_restore(blob), fresh.msgpack_restore(blob))
    with pytest.raises(ValueError, match="not a msgpack type"):
        fresh.msgpack_restore(b"\xc1")
    with pytest.raises(ValueError, match="ends inside"):
        fresh.msgpack_restore(blob[:-3])


def test_jax_checkpoint_loads_into_the_port(tmp_path, capsys):
    params = _jax_case("swin_unetr")[3]
    path = tmp_path / "jax.ckpt"
    _jax_checkpoint(path, params)
    assert ckpt.checkpoint_format(path) == "flax"
    target = model_from_config(Config(**SWIN), device="cpu").state_dict()
    merged = ckpt.load_any_checkpoint_params(path, target, model_name="swin_unetr")
    _same(merged, state_dict_from_jax(params))
    assert "optimizer state is not restored" in capsys.readouterr().out
    garbage = tmp_path / "notes.txt"
    garbage.write_text("not a checkpoint")
    with pytest.raises(ValueError, match="msgpack.*\\.pt/\\.ckpt") as e:
        ckpt.load_any_checkpoint_params(garbage, target, model_name="swin_unetr")
    assert all(f in str(e.value) for f in ckpt.FORMATS)


def test_batch_norm_jax_checkpoint_keeps_init_statistics(tmp_path, capsys):
    """W9: a JAX file of a batch-norm model holds no running statistics."""
    cfg = dict(MODELS["unet_vanilla"], decoder_norm_name="batch")
    jmodel = jax_model_from_config(JConfig(**cfg))
    params = seeded_params(jmodel, jnp.zeros((1, 16, 16, 16, 1)), jnp.zeros((1,), jnp.int32))
    path = tmp_path / "bn.ckpt"
    jax_save_checkpoint(path, params=params)
    target = model_from_config(Config(**cfg), device="cpu").state_dict()
    stats = [k for k in target if k.endswith((".mean", ".var"))]
    assert stats
    merged = ckpt.load_any_checkpoint_params(path, target, model_name="unet_vanilla")
    for k in stats:
        assert torch.equal(merged[k], torch.full_like(target[k], 0.0 if k.endswith("mean")
                                                       else 1.0)), k
    bridged = state_dict_from_jax(params)
    assert all(torch.equal(merged[k], bridged[k]) for k in bridged)
    assert f"{len(stats)} buffers stay at their init (mean 0, var 1)" in capsys.readouterr().out


def test_cli_test_on_a_jax_best_ckpt_matches_jax(dataset, tmp_path):
    params = _jax_case("unet")[3]
    best = tmp_path / "best.ckpt"
    _jax_checkpoint(best, params)
    cfg = dict(MODELS["unet"], no_amp=True, precision="fp32", ckpt_path=str(best),
               data_dirs=[str(dataset)] * 2, json_lists=["CT.json", "MR.json"],
               num_workers=0, default_root_dir=str(tmp_path))
    want = jax_cli_test.main(JConfig(**cfg))
    got = cli_test.main(Config(**cfg), device="cpu")
    assert got.keys() == want.keys()
    gaps = {k: abs(got[k] - want[k]) for k in got if np.isfinite(want[k])}
    assert all(got[k] == want[k] for k in got if not np.isfinite(want[k]))
    worst = max(gaps, key=gaps.get)
    print(f"cli.test on a JAX best.ckpt: {len(got)} metrics, worst |port - jax| "
          f"{worst} {gaps[worst]:.2e}")
    assert gaps[worst] <= ATOL_METRIC
