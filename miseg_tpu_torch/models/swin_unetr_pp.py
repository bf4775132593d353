"""Pipeline-parallel Swin-UNETR forward: the swin backbone's four
`BasicLayer` stages as GPipe stages over this rank's line of a mesh's
pipeline axis (counterpart of `miseg_tpu/models/swin_unetr_pp.py`).

Each stage ends in patch merging, which halves the grid and doubles the
channels, so the schedule is `parallel.pipeline.pipeline_apply_hetero`:
each boundary carries its own shape, and the last stage receives every
stage's output, the decoder's skip taps `hidden[1..4]`.  `hidden[0]`,
the patch embedding's output, is computed on stage 0 (the pipeline's
input) and again on the last stage (the decoder's tap) from the image
every rank holds: each rank backpropagates its own use of the patch
embedding, and the sum over the line counts each use once.  The
parameter-free `proj_out` and the conv encoders and decoders run on the
last stage on the whole batch, as JAX's data-parallel side does; with
`use_checkpoint` the stages' blocks and the conv blocks recompute in the
backward (`nn/recompute.py`), as JAX's remat does.

Under spatial partitioning each (data, spatial) coordinate runs its own
pipeline line, and every tensor keeps the state its level takes (D7):
the stages run their blocks on slabs (or whole levels) exchanging halos,
statistics and window rows among the ranks of one stage's spatial line,
and each stage boundary carries its level's slab or whole volume; the
last stage runs `hidden[0]` and the decoder on the slabs (ROADMAP D13).

Equivalence: with every drop rate at 0 this is the serial
`SwinUNETR.forward` on the same parameters (tests/test_torch_pipeline.py,
against the serial model and JAX's `swin_unetr_pipeline_forward`).  A
drop rate above 0 in training raises `ValueError`, as JAX's does.
"""

from __future__ import annotations

from ..nn import recompute
from ..parallel import spatial
from ..parallel.pipeline import pipeline_apply_hetero
from .swin_unetr import SwinUNETR


def swin_unetr_pipeline_forward(model: SwinUNETR, x_in, modalities, *, mesh,
                                microbatches: int, axis: str = "pp", train: bool = False):
    """SwinUNETR's logits with its swin stages GPipe-scheduled over this
    rank's `axis` line of `mesh` (one stage a rank: the line must have
    `len(depths)` ranks), every rank passing the same `x_in [B, *spatial,
    Cin]` (under spatial partitioning, its slab) and `modalities int[B]`.
    Returns `(logits or None, schedule)`: the logits on the last stage,
    None on the others; `schedule.backward()` backpropagates the pipeline
    on every rank."""
    if train and any(model.drop_rates):
        raise ValueError("pipeline_parallel requires all drop rates == 0 (in-stage rng "
                         "folding differs from the serial module-path folding)")
    sw = model.swinViT
    n_stages, stage = mesh.size(axis), mesh.index(axis)
    if n_stages != sw.num_layers:
        raise ValueError(f"swin_unetr pipeline needs mesh['{axis}'] == {sw.num_layers} "
                         f"stages, got {n_stages}")
    fs = model.feature_size
    s0 = tuple(d // 2 for d in spatial.global_dims(x_in))   # the patch embedding's grid
    # each boundary's per-sample shape on this rank: its slab where the
    # level rule shards its level
    shapes = [(*spatial.local_dims(tuple(d // 2 ** i for d in s0)), fs * 2 ** i)
              for i in range(n_stages + 1)]
    last = stage == n_stages - 1
    x0 = sw.pos_drop(sw.patch_embed(x_in, modalities)) if stage == 0 or last else None
    stage_fns = [getattr(sw, f"layers{i + 1}") for i in range(n_stages)]
    ys, schedule = pipeline_apply_hetero(
        stage_fns, x0 if stage == 0 else None, modalities, mesh=mesh, axis=axis,
        microbatches=microbatches, like=x_in, shapes=shapes)
    if ys is None:
        return None, schedule
    hidden = [sw._proj_out(h, model.normalize) for h in (x0, *ys)]

    def block(module, *args):
        return recompute.call(module, *args, modalities, recompute=model.use_checkpoint)

    enc0 = block(model.encoder1, x_in)
    enc1 = block(model.encoder2, hidden[0])
    enc2 = block(model.encoder3, hidden[1])
    enc3 = block(model.encoder4, hidden[2])
    dec4 = block(model.encoder10, hidden[4])
    dec3 = block(model.decoder5, dec4, hidden[3])
    dec2 = block(model.decoder4, dec3, enc3)
    dec1 = block(model.decoder3, dec2, enc2)
    dec0 = block(model.decoder2, dec1, enc1)
    out = block(model.decoder1, dec0, enc0)
    return model.out(out), schedule
