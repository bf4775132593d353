"""Training in the port against the JAX package (CPU, f32).

* One train step of the fs-12 C-Swin-UNETR (heads 2, 32^3, batch 2,
  modalities [0, 1], `dice_focal`, AdamW) on both conv paths against what
  JAX's `_build_train_step` (engine.py:239-269) computes: loss within
  1e-5, every gradient leaf within 5e-5 and their sum within 1e-3
  (tests/test_grad_parity_slow.py's gate), the parameters after the step
  within rtol 1e-4 / atol 2.5e-4 (ROADMAP W5, tests/test_fsdp.py:163-169).
* The optimizers against optax (three steps, atol 1e-7), the bf16 policy
  (f32 masters, f32 gradients) and K4's packed-weight cache after an
  optimizer step.
The kernels' autograd Functions are held against `jax.vjp` in
tests/test_torch_autograd.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from test_torch_bridge import max_err, seeded_params, t

from miseg_tpu import losses as JL
from miseg_tpu.config import Config as JConfig
from miseg_tpu.models import model_from_config as jax_model_from_config
from miseg_tpu.train.optim import optimizer_from_config as j_optimizer_from_config
from miseg_tpu_torch.config import Config
from miseg_tpu_torch.ops.kernels import fused_conv
from miseg_tpu_torch.train import engine
from miseg_tpu_torch.train.optim import optimizer_from_config
from miseg_tpu_torch.weights import state_dict_from_jax

torch.set_num_threads(1)
ATOL_LOSS = 1e-5
ATOL_LEAF, ATOL_LEAF_SUM = 5e-5, 1e-3
RTOL_STEP, ATOL_STEP = 1e-4, 2.5e-4
_CFG = dict(model_name="swin_unetr", out_channels=4, feature_size=[12],
            num_heads=2, depth_swin_block=[2], roi_x=32, roi_y=32, roi_z=32,
            encoder_norm_name="instance_cond", vit_norm_name="instance_cond",
            decoder_norm_name="instance", criterion="dice_focal", optim_name="adamw",
            lr=1e-4, reg_weight=1e-5, no_amp=True)


def _rand(rng, shape, scale=1.0, mean=0.0):
    return (mean + scale * rng.standard_normal(shape)).astype(np.float32)


# -------------------------------------------------------- whole step ----

@pytest.fixture(scope="module")
def jax_step():
    """What JAX's `_build_train_step` computes for one step: the loss and
    gradients (`jax.jit(jax.value_and_grad)` of the model's apply under
    `loss_from_config`) and the parameters after one update of
    `optimizer_from_config`'s transform."""
    rng = np.random.default_rng(3)
    image = rng.standard_normal((2, 32, 32, 32, 1)).astype(np.float32)
    label = rng.integers(0, 4, (2, 32, 32, 32)).astype(np.int32)
    mods = np.array([0, 1], np.int32)
    jcfg = JConfig(**_CFG)
    jmodel = jax_model_from_config(jcfg)
    params = seeded_params(jmodel, jnp.asarray(image), jnp.asarray(mods))
    loss_fn = JL.loss_from_config(jcfg)

    def loss_of(p):
        logits = jmodel.apply({"params": p}, image, mods, train=True)
        return loss_fn(logits.astype(jnp.float32), label)

    jparams = jax.tree.map(jnp.asarray, params)
    loss, grads = jax.jit(jax.value_and_grad(loss_of))(jparams)
    tx = j_optimizer_from_config(jcfg)

    def update(g, p):   # jitted: eager optax takes ~30 s over 203 leaves here
        return optax.apply_updates(p, tx.update(g, tx.init(p), p)[0])

    new = jax.jit(update)(grads, jparams)
    return dict(batch={"image": image, "label": label[..., None], "modality": mods},
                params=params, loss=float(loss),
                grads=state_dict_from_jax(jax.tree.map(np.array, grads)),
                new=state_dict_from_jax(jax.tree.map(np.array, new)))


@pytest.mark.parametrize("fused_conv", [True, False])
def test_train_step_matches_jax(jax_step, fused_conv):
    trainer = engine.Trainer(Config(**_CFG), device="cpu", fused_conv=fused_conv)
    state = trainer.init_state(state_dict_from_jax(jax_step["params"]))
    assert len(state.params) == 203
    state, loss = trainer.train_step(state, jax_step["batch"])
    assert state.step == 1
    loss_err = abs(float(loss) - jax_step["loss"])
    gaps = {n: max_err(p.grad, jax_step["grads"][n]) for n, p in state.params.items()}
    worst = max(gaps, key=gaps.get)
    print(f"fused_conv={fused_conv}: loss {float(loss):.6f} |diff| {loss_err:.2e}; gradient "
          f"gap summed over {len(gaps)} leaves {sum(gaps.values()):.3e}, worst {worst} "
          f"{gaps[worst]:.2e}")
    assert loss_err <= ATOL_LOSS
    assert sum(gaps.values()) <= ATOL_LEAF_SUM and gaps[worst] <= ATOL_LEAF
    for n, p in state.params.items():
        np.testing.assert_allclose(p.detach().numpy(), jax_step["new"][n].numpy(),
                                   rtol=RTOL_STEP, atol=ATOL_STEP, err_msg=n)


def test_bf16_policy_keeps_f32_masters(rng):
    """bf16 compute: the model sees bf16 parameters and activations; the
    masters and their gradients stay f32; the logits come back f32."""
    cfg = Config(**dict(_CFG, no_amp=False, precision="bf16"))
    trainer = engine.Trainer(cfg, device="cpu")
    state = trainer.init_state()
    seen = {}
    trainer.model.encoder1.register_forward_hook(
        lambda m, a, out: seen.update(act=out.dtype, w=m.layer.conv1.conv.weight.dtype))
    batch = {"image": _rand(rng, (1, 32, 32, 32, 1)),
             "label": rng.integers(0, 4, (1, 32, 32, 32)), "modality": np.array([1])}
    loss, grads = trainer.value_and_grad(state, batch)
    assert seen == {"act": torch.bfloat16, "w": torch.bfloat16}
    assert loss.dtype == torch.float32 and torch.isfinite(loss)
    assert all(p.dtype == torch.float32 for p in state.params.values())
    assert all(g is not None and g.dtype == torch.float32 and torch.isfinite(g).all()
               for g in grads.values())
    logits = trainer.apply_fn(state.params, t(batch["image"]), t(batch["modality"]))
    assert logits.dtype == torch.float32


# --------------------------------------------------------- optimizers ----

@pytest.mark.parametrize("name", ["adamw", "adam", "sgd"])
def test_optimizer_matches_optax(rng, name):
    kw = dict(optim_name=name, lr=1e-3, reg_weight=1e-2, momentum=0.99)
    tree = {"a": _rand(rng, (4, 5), 0.3), "b": _rand(rng, (7,), 0.3)}
    grads = [{k: _rand(rng, v.shape) for k, v in tree.items()} for _ in range(3)]
    tx = j_optimizer_from_config(JConfig(**kw))
    jp = jax.tree.map(jnp.asarray, tree)
    state = tx.init(jp)
    params = {k: torch.nn.Parameter(t(v)) for k, v in tree.items()}
    opt = optimizer_from_config(Config(**kw), params.values())
    for g in grads:
        updates, state = tx.update(jax.tree.map(jnp.asarray, g), state, jp)
        jp = optax.apply_updates(jp, updates)
        for k, p in params.items():
            p.grad = t(g[k])
        opt.step()
    for k, p in params.items():
        assert max_err(p, jp[k]) <= 1e-7, (k, max_err(p, jp[k]))


def test_unknown_optimizer_raises():
    with pytest.raises(ValueError, match="not implemented"):
        optimizer_from_config(Config(optim_name="lamb"), [torch.nn.Parameter(torch.zeros(2))])


@pytest.mark.parametrize("foreach", [False, True])
def test_kernel_weights_cache_rebuilds_after_step(rng, foreach):
    """K4's packed `[3, 3, 3, I, O]` copy is cached on the weight and keyed
    on its version: an in-place optimizer step rebuilds it."""
    w = torch.nn.Parameter(t(_rand(rng, (6, 4, 3, 3, 3), 0.2)))
    opt = torch.optim.AdamW([w], lr=1e-2, foreach=foreach)
    first = fused_conv.kernel_weights(w, torch.bfloat16)
    assert fused_conv.kernel_weights(w, torch.bfloat16) is first
    w.grad = t(_rand(rng, w.shape))
    opt.step()
    again = fused_conv.kernel_weights(w, torch.bfloat16)
    assert again is not first
    assert torch.equal(again, w.detach().to(torch.bfloat16).permute(2, 3, 4, 1, 0))
    assert not torch.equal(again, first)
