"""Activation recompute (`use_checkpoint`, `nn/recompute.py`) against the
step without it and against the JAX package's remat'd step (CPU).

* swin_unetr (both conv paths) and unetr at fs 12 / 8, 32^3, batch 2,
  with dropout, attention dropout and drop-path > 0: the loss and every
  gradient of one step with recompute equal the same step without it
  within 1e-6 (the same dropout generator seed), in f32 and in the bf16
  policy, with a batch-norm decoder whose running statistics move once a
  step; each module the JAX package remats runs its forward twice a
  step (hooks), and nothing else does.  Negative control: a recompute
  that draws fresh dropout masks breaks the gradients.
* One step of each model with `use_checkpoint` (dropout 0: the two
  packages draw different masks) against JAX's jitted `value_and_grad`
  of the model built with `use_checkpoint=True`: loss within 1e-5, every
  gradient leaf within 5e-5 and their sum within 1e-3
  (tests/test_torch_train.py's gates).
* Serving is unchanged: with grad mode off the blocks run once and no
  checkpoint wraps them.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_bridge import max_err, seeded_params

from miseg_tpu import losses as JL
from miseg_tpu.config import Config as JConfig
from miseg_tpu.models import model_from_config as jax_model_from_config
from miseg_tpu_torch.config import Config
from miseg_tpu_torch.nn import dropout, recompute
from miseg_tpu_torch.nn.swin import SwinTransformerBlock
from miseg_tpu_torch.nn.unetr_blocks import UnetrBasicBlock, UnetrPrUpBlock, UnetrUpBlock
from miseg_tpu_torch.train import engine
from miseg_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(1)
ATOL_SAME = 1e-6
ATOL_LOSS, ATOL_LEAF, ATOL_LEAF_SUM = 1e-5, 5e-5, 1e-3
DROP = dict(dropout_rate=0.1, attn_drop_rate=0.1, dropout_path_rate=0.2)
MODELS = {
    "swin_unetr": dict(model_name="swin_unetr", out_channels=4, feature_size=[12], num_heads=2,
                       roi_x=32, roi_y=32, roi_z=32, encoder_norm_name="instance_cond",
                       vit_norm_name="instance_cond", decoder_norm_name="instance",
                       criterion="dice_focal", no_amp=True),
    "unetr": dict(model_name="unetr", out_channels=4, feature_size=[8], hidden_size=48,
                  mlp_dim=96, num_heads=4, roi_x=32, roi_y=32, roi_z=32,
                  encoder_norm_name="instance_cond", vit_norm_name="instance_cond",
                  criterion="dice_focal", no_amp=True),
}
# what the JAX package remats (miseg_tpu/models/swin_transformer.py:68,
# swin_unetr.py:89-108, unetr.py:86-125), by module class
REMAT = {"swin_unetr": {SwinTransformerBlock: 8, UnetrBasicBlock: 5, UnetrUpBlock: 5},
         "unetr": {UnetrBasicBlock: 1, UnetrUpBlock: 4}}


def _batch(seed: int = 0):
    rng = np.random.default_rng(seed)
    return {"image": rng.standard_normal((2, 32, 32, 32, 1)).astype(np.float32),
            "label": rng.integers(0, 4, (2, 32, 32, 32)).astype(np.int32),
            "modality": np.array([0, 1], np.int32)}


def _step(cfg: dict, use_checkpoint: bool, fused_conv: bool = True, params=None):
    """(loss, gradients by name, buffers after the step, forward calls by
    module class) of one `value_and_grad`, with the trainer's dropout
    generator seeded as at step 0."""
    trainer = engine.Trainer(Config(**cfg, use_checkpoint=use_checkpoint), device="cpu",
                             fused_conv=fused_conv)
    calls: dict[type, int] = {}
    for m in trainer.model.modules():
        if isinstance(m, (SwinTransformerBlock, UnetrBasicBlock, UnetrUpBlock, UnetrPrUpBlock)):
            m.register_forward_hook(
                lambda mod, a, out: calls.__setitem__(type(mod), calls.get(type(mod), 0) + 1))
    state = trainer.init_state(params)
    loss, grads = trainer.value_and_grad(state, _batch())
    return (float(loss), {n: g.clone() for n, g in grads.items()},
            {n: b.clone() for n, b in state.buffers.items()}, calls)


CASES = [("swin_unetr", True, {}), ("swin_unetr", False, {}), ("unetr", True, {}),
         ("swin_unetr", True, {"no_amp": False, "decoder_norm_name": "batch"})]


@pytest.mark.parametrize("name,fused_conv,extra", CASES,
                         ids=["swin", "swin-unfused", "unetr", "swin-bf16-batchnorm"])
def test_recompute_equals_the_plain_step(name, fused_conv, extra):
    cfg = {**MODELS[name], **DROP, **extra}
    loss0, grads0, bufs0, calls0 = _step(cfg, False, fused_conv)
    loss1, grads1, bufs1, calls1 = _step(cfg, True, fused_conv)
    assert calls1 == {k: 2 * v for k, v in calls0.items() if k in REMAT[name]} | {
        k: v for k, v in calls0.items() if k not in REMAT[name]}
    assert {k: v for k, v in calls0.items() if k in REMAT[name]} == REMAT[name]
    assert abs(loss1 - loss0) <= ATOL_SAME
    gaps = {n: max_err(grads1[n], grads0[n]) for n in grads0}
    worst = max(gaps, key=gaps.get)
    print(f"{name} fused_conv={fused_conv} {extra}: loss {loss0:.6f}, recompute vs plain "
          f"loss |diff| {abs(loss1 - loss0):.1e}, worst gradient {worst} {gaps[worst]:.1e}")
    assert gaps[worst] <= ATOL_SAME
    if extra.get("decoder_norm_name") == "batch":
        assert bufs0 and all(torch.equal(bufs1[n], bufs0[n]) for n in bufs0)
        assert not all(torch.equal(b, torch.zeros_like(b)) for b in bufs0.values())


def test_recompute_with_fresh_masks_breaks_the_gradients(monkeypatch):
    """Negative control: a recompute that draws new dropout masks (a fresh
    generator instead of the snapshot's state) gives other gradients."""
    cfg = {**MODELS["swin_unetr"], **DROP}
    _, want, _, _ = _step(cfg, False)
    monkeypatch.setattr(recompute.dropout, "replay",
                        lambda snap: dropout.rng(torch.Generator().manual_seed(1234)))
    _, got, _, _ = _step(cfg, True)
    worst = max(max_err(got[n], want[n]) for n in want)
    print(f"fresh masks in the recompute: worst gradient gap {worst:.3e}")
    assert worst > 100 * ATOL_SAME


@pytest.mark.parametrize("name", sorted(MODELS))
def test_recompute_step_matches_jax_remat(name):
    cfg = MODELS[name]
    batch = _batch(1)
    jcfg = JConfig(**cfg, use_checkpoint=True)
    jmodel = jax_model_from_config(jcfg)
    assert jmodel.use_checkpoint
    params = seeded_params(jmodel, jnp.asarray(batch["image"]), jnp.asarray(batch["modality"]),
                           seed=2)
    loss_fn = JL.loss_from_config(jcfg)

    def loss_of(p):
        logits = jmodel.apply({"params": p}, batch["image"], batch["modality"], train=True)
        return loss_fn(logits.astype(jnp.float32), batch["label"])

    jloss, jgrads = jax.jit(jax.value_and_grad(loss_of))(jax.tree.map(jnp.asarray, params))
    want = state_dict_from_jax(jax.tree.map(np.array, jgrads))
    trainer = engine.Trainer(Config(**cfg, use_checkpoint=True), device="cpu")
    state = trainer.init_state(state_dict_from_jax(params))
    loss, grads = trainer.value_and_grad(state, {**batch, "label": batch["label"][..., None]})
    gaps = {n: max_err(g, want[n]) for n, g in grads.items()}
    worst = max(gaps, key=gaps.get)
    print(f"{name} with use_checkpoint: loss {float(loss):.6f} |diff| "
          f"{abs(float(loss) - float(jloss)):.2e}; gradient gap summed over {len(gaps)} leaves "
          f"{sum(gaps.values()):.3e}, worst {worst} {gaps[worst]:.2e}")
    assert abs(float(loss) - float(jloss)) <= ATOL_LOSS
    assert gaps[worst] <= ATOL_LEAF and sum(gaps.values()) <= ATOL_LEAF_SUM


def test_serving_runs_each_block_once(monkeypatch):
    """Without grad mode the blocks run as they are: no checkpoint."""
    trainer = engine.Trainer(Config(**MODELS["swin_unetr"], use_checkpoint=True), device="cpu")
    trainer.init_state()
    monkeypatch.setattr(recompute.checkpoint, "checkpoint", None)   # would raise if called
    x = torch.from_numpy(_batch()["image"][:1])
    with torch.inference_mode():
        out = trainer.make_inferer()(x, torch.tensor([0], dtype=torch.int32))
    assert out.shape == (1, 32, 32, 32, 4) and bool(torch.isfinite(out).all())
