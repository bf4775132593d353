"""Pipeline-parallel UNETR forward: the ViT's blocks as S GPipe stages over
this rank's line of a mesh's pipeline axis (counterpart of
`miseg_tpu/models/unetr_pp.py`).

The decoder taps the hidden states after blocks L/4, L/2 and 3L/4, which
fall inside stages in general: the stage that runs such a block sends
its output to the last stage beside the activation
(`parallel.pipeline.pipeline_apply`'s taps), valid for any stage count
that divides the layers.  Stage 0 runs the patch embedding; the last
stage runs the ViT's final norm, the encoders, the decoders and the
output block on the whole batch, as JAX's data-parallel side does, so
every term of the loss is computed on one rank.

Under spatial partitioning each (data, spatial) coordinate runs its own
pipeline line, and the ViT runs as in the serial model (D10): stage 0
embeds the gathered input (`gather_d` over its spatial line) and every
stage carries whole tokens on every rank of its spatial line, with the
partition suspended; the last stage settles the token volumes and runs
the decoder on the slabs, its halos and statistics exchanged among the
last stage's ranks (ROADMAP D13).

Equivalence: with dropout off this is the serial `UNETR.forward` on the
same parameters (tests/test_torch_pipeline.py, against the serial model
and JAX's `unetr_pipeline_forward`).  Dropout in training raises
`ValueError`, as JAX's does (its in-stage rng folding would differ).
"""

from __future__ import annotations

import math

from ..nn import recompute
from ..parallel import spatial
from ..parallel.pipeline import pipeline_apply, stage_layers
from .unetr import UNETR


def unetr_pipeline_forward(model: UNETR, x_in, modalities, *, mesh, microbatches: int,
                           axis: str = "pp", train: bool = False):
    """UNETR's logits with the ViT's blocks GPipe-scheduled over this
    rank's `axis` line of `mesh`, every rank passing the same `x_in [B,
    *spatial, Cin]` (under spatial partitioning, its slab) and
    `modalities int[B]`.  The parameters are the
    model's own (the Trainer substitutes its compute-dtype casts of the
    replicated masters).  Returns `(logits or None, schedule)`: the logits
    `[B, *spatial, out_channels]` on the last stage, None on the others;
    `schedule.backward()` backpropagates the pipeline on every rank."""
    if model.dropout_rate and train:
        raise ValueError("pipeline_parallel requires dropout_rate == 0 (in-stage rng "
                         "folding differs from the serial module-path folding)")
    if model.needs_modalities and modalities is None:
        raise ValueError("Modalities must be passed to the forward step when a norm is "
                         "'instance_cond'.")
    n_stages, stage = mesh.size(axis), mesh.index(axis)
    n_layers = model.num_layers
    if n_layers % n_stages:
        raise ValueError(f"num_layers {n_layers} not divisible by {n_stages} pipeline stages")
    blocks = stage_layers(n_layers, n_stages, stage)
    per, q = n_layers // n_stages, n_layers // 4
    taps = (q, 2 * q, 3 * q)
    vit = model.vit

    def stage_fn(h, mods):
        out = []
        with spatial.suspended():
            for i in blocks:
                h = getattr(vit, f"blocks_{i}")(h, mods)
                if i in taps:
                    out.append(h)
        return h, out

    tokens = None
    if stage == 0:
        line = spatial.line_of(x_in)
        with spatial.suspended():
            tokens = vit.patch_embedding(x_in if line is None else spatial.gather_d(x_in, line))
    result, schedule = pipeline_apply(
        stage_fn, tokens, modalities, mesh=mesh, axis=axis, microbatches=microbatches,
        like=x_in, shape=(math.prod(model.feat_size), model.hidden_size), with_aux=True,
        aux=[sum(t // per == r for t in taps) for r in range(n_stages)])
    if result is None:
        return None, schedule
    y, hs = result

    def hidden(i):   # the ViT's hidden state after block i
        r = i // per
        return hs[r][sum(t // per == r and t < i for t in taps)]

    def block(module, *args):
        return recompute.call(module, *args, modalities, recompute=model.use_checkpoint)

    x = vit.norm(y, modalities)
    enc1 = block(model.encoder1, x_in)
    enc2 = model.encoder2(model.proj_feat(hidden(q)), modalities)
    enc3 = model.encoder3(model.proj_feat(hidden(2 * q)), modalities)
    enc4 = model.encoder4(model.proj_feat(hidden(3 * q)), modalities)
    dec3 = block(model.decoder5, model.proj_feat(x), enc4)
    dec2 = block(model.decoder4, dec3, enc3)
    dec1 = block(model.decoder3, dec2, enc2)
    out = block(model.decoder2, dec1, enc1)
    return model.out(out), schedule
