"""The five kernels as registered ops (`miseg::*`, `torch.library`) on the
CPU: `opcheck` of each op (schema, fake implementation, autograd
registration, AOT dispatch) at the arguments the models give it; the
wrappers' traced route (the ops, taken while tracing) against their eager
route (the launchers, here the plain versions) on the same inputs,
bitwise; and a C-Swin-UNETR window exported with `torch.export` holding
a `miseg::` node for every kernel call, K4 with its fold inside, and none
of the plain versions' code.  The ops' CUDA kernels run in
`tests/test_torch_cuda.py` and `chip_smoke.py`."""

import collections

import pytest
import torch

from miseg_tpu_torch.config import Config
from miseg_tpu_torch.models import model_from_config
from miseg_tpu_torch.ops.kernels import fused_conv as FC
from miseg_tpu_torch.ops.kernels import fused_norm as FN
from miseg_tpu_torch.ops.kernels import window_attention as WA
from miseg_tpu_torch.serve import export_bundle

torch.set_num_threads(1)
OPS = ("channel_scale_shift", "apply_scale_shift", "apply_norm2_act", "conv3_norm_columns",
       "window_attention")


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _cases():
    """(op name, label, args) at small versions of the models' shapes."""
    g = _gen()
    x3 = torch.randn((2, 40, 12), generator=g)
    banks = (1 + 0.1 * torch.randn((2, 12), generator=g), 0.1 * torch.randn((2, 12), generator=g))
    styles = torch.tensor([1, 0], dtype=torch.int32)
    sc, sh = torch.randn((2, 12), generator=g), torch.randn((2, 12), generator=g)
    x5 = torch.randn((2, 4, 3, 5, 8), generator=g)
    w = torch.randn((6, 8, 3, 3, 3), generator=g) / 15
    c8 = (torch.randn((2, 8), generator=g), torch.randn((2, 8), generator=g))
    qkv = torch.randn((4, 8, 24), generator=g)
    bias = torch.randn((2, 8, 8), generator=g)
    ids = torch.randint(0, 3, (2, 8), generator=g, dtype=torch.int32)
    return [
        ("channel_scale_shift", "no affine", (x3, None, None, None, 1e-5)),
        ("channel_scale_shift", "[C] affine", (x3, banks[0][0], banks[1][0], None, 1e-5)),
        ("channel_scale_shift", "banks", (x3, *banks, styles, 1e-5)),
        ("apply_scale_shift", "plain", (x3, sc, sh, None, None)),
        ("apply_scale_shift", "add + leaky", (x3, sc, sh, x3.flip(1), 0.01)),
        ("apply_norm2_act", "leaky", (x3, sc, sh, x3.flip(1), sh, sc, 0.01)),
        ("conv3_norm_columns", "no prologue", (x5, w, None, None, None, None, None, None, 1e-5)),
        ("conv3_norm_columns", "prologue + banks",
         (x5, w, *c8, banks[0][:, :6], banks[1][:, :6], styles, 0.01, 1e-5)),
        # K4's D-halo mode: x5 as a slab of 2 planes with a halo plane a side
        ("conv3_halo_moments", "no prologue, low plane padding", (x5, w, None, None, None,
                                                                  True, False)),
        ("conv3_halo_moments", "prologue, interior", (x5, w, *c8, 0.01, False, False)),
        ("window_attention", "strided views, mask",
         (qkv[..., :8], qkv[..., 8:16], qkv[..., 16:], bias, ids, 2)),
        ("window_attention", "no mask", (qkv[..., :8], qkv[..., 8:16], qkv[..., 16:], bias,
                                          None, 2)),
    ]


CASES = _cases()
IDS = [f"{op}-{label}" for op, label, _ in CASES]


@pytest.mark.parametrize("op,label,args", CASES, ids=IDS)
def test_opcheck(op, label, args):
    """Every test of `torch.library.opcheck` passes: the ops register no
    autograd of their own, and these inputs need no gradient."""
    result = torch.library.opcheck(getattr(torch.ops.miseg, op).default, args)
    assert set(result.values()) == {"SUCCESS"}, result


def _eager_and_traced(op, args):
    """The public wrapper's result on its eager route and on its traced
    route (`torch.compiler.is_compiling()` forced true)."""
    wrappers = {
        "channel_scale_shift": lambda a: FN.channel_scale_shift(a[0], *a[1:4], eps=a[4]),
        "apply_scale_shift": lambda a: FN.apply_scale_shift(*a[:4], negative_slope=a[4]),
        "apply_norm2_act": lambda a: FN.apply_norm2_act(*a[:6], negative_slope=a[6]),
        "conv3_norm_columns": lambda a: FC.conv3_norm_columns(
            *a[:4], gamma=a[4], beta=a[5], styles=a[6], slope=a[7], eps=a[8]),
        "conv3_halo_moments": lambda a: FC.conv3_halo_moments(
            *a[:4], slope=a[4], pad_lo=a[5], pad_hi=a[6]),
        "window_attention": lambda a: WA.window_attention(*a[:5], num_heads=a[5]),
    }
    with torch.no_grad():
        eager = wrappers[op](args)
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(torch.compiler, "is_compiling", lambda: True)
            traced = wrappers[op](args)
    as_tuple = lambda r: r if isinstance(r, tuple) else (r,)  # noqa: E731
    return as_tuple(eager), as_tuple(traced)


@pytest.mark.parametrize("op,label,args", CASES, ids=IDS)
def test_traced_route_equals_eager_route(op, label, args):
    eager, traced = _eager_and_traced(op, args)
    assert len(eager) == len(traced)
    for e, t in zip(eager, traced):
        assert e.shape == t.shape and e.dtype == t.dtype
        assert torch.equal(e, t)


@pytest.fixture(scope="module")
def exported(tmp_path_factory):
    cfg = Config(model_name="swin_unetr", out_channels=3, feature_size=[12], num_heads=2,
                 roi_x=32, roi_y=32, roi_z=32, encoder_norm_name="instance_cond",
                 vit_norm_name="instance_cond", decoder_norm_name="instance", no_amp=True)
    model = model_from_config(cfg, device="cpu")
    out = export_bundle(cfg, model.state_dict(), tmp_path_factory.mktemp("ops") / "b",
                        platforms=("cpu",))
    return model, torch.export.load(out / "window_fn.pt2")


def test_exported_window_holds_every_kernel_as_an_op(exported):
    """One `miseg::` node for each kernel call the model makes in an eager
    window (counted at the launchers), and nothing of the plain versions'
    code: no softmax, statistics, rsqrt, einsum, bmm or where.  (At 32^3 the
    bottleneck block sees 1^3, which K4 does not take: its convs are the
    unfused path's cuDNN convs, in the graph as they are in eager.)"""
    model, program = exported
    calls = collections.Counter()
    graph = collections.Counter(str(n.target) for n in program.graph.nodes
                                if n.op == "call_function")
    # the model's own kernel calls in one eager window, by wrapper
    counted = {"channel_scale_shift": (FN, "_channel_scale_shift"),
               "apply_scale_shift": (FN, "_apply_scale_shift"),
               "apply_norm2_act": (FN, "_apply_norm2_act"),
               "conv3_norm_columns": (FC, "_conv3_norm_columns"),
               "window_attention": (WA, "_window_attention")}
    with pytest.MonkeyPatch.context() as mp:
        for name, (mod, attr) in counted.items():
            fn = getattr(mod, attr)
            mp.setattr(mod, attr, lambda *a, _f=fn, _n=name, **k: (calls.update([_n]),
                                                                   _f(*a, **k))[1])
        with torch.no_grad():
            model(torch.zeros((1, 32, 32, 32, 1)), torch.zeros((1,), dtype=torch.int32))
    for name in OPS:
        assert calls[name] > 0, name
        assert graph[f"miseg.{name}.default"] == calls[name], (name, graph, calls)
    plain = [k for k in graph if any(p in k for p in ("softmax", "var", "mean", "rsqrt",
                                                      "einsum", "bmm", "where"))]
    assert not plain, plain


def test_exported_window_equals_the_live_model(exported):
    model, program = exported
    g = _gen(3)
    x = torch.randn((1, 32, 32, 32, 1), generator=g)
    mods = torch.tensor([1], dtype=torch.int32)
    weights = {k: v.detach() for k, v in model.state_dict().items()}
    with torch.no_grad():
        want = model(x, mods)
        got = program.module()(weights, x, mods)
    assert (got - want).abs().max() <= 1e-5
