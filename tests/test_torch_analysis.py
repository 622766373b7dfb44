"""Model analysis of the port (``u2seg_torch/utils/analysis.py``,
``u2seg_torch/tools/analyze_model.py``) against the JAX package's, on the
tiny config of ``test_torch_export.py`` at 64x64.

- Parameters: the total and the count under each top module equal the JAX
  tree's, the port's seeded weights carried over by
  ``convert_d2_panoptic_fpn`` (the weight bridge). Exact.
- Conv FLOPs: ``FlopCounterMode``'s ``aten.convolution`` count equals the
  ``conv_general_dilated`` FLOPs summed over the JAX forward's jaxpr
  (2 x output elements x kernel taps x input channels per group, divided by
  the input dilation: the mask head's 2x2 stride-2 transposed conv reads one
  tap in four). Exact.
- The whole count: FlopCounterMode counts convs, GEMMs, attention and the K1
  op's formula, where XLA's ``cost_analysis()`` also counts elementwise work,
  reductions and the gathers; on this config the ratio port / XLA lies in
  [0.9, 1.0] (measured 0.966: 424.0 / 438.7 MFLOPs). The bytes are not
  compared: XLA counts its fused programs, the port every aten op (13x more
  here).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from u2seg_tpu.config import config as jconfig
from u2seg_tpu.engine.checkpoint import convert_d2_panoptic_fpn
from u2seg_tpu.models.panoptic_fpn import PanopticFPN as JPanopticFPN
from u2seg_tpu.utils import analysis as janalysis
from u2seg_torch import config as tconfig
from u2seg_torch.models.build import build_model
from u2seg_torch.ops import roi_align_ml as rap
from u2seg_torch.tools import analyze_model
from u2seg_torch.utils import analysis

from test_torch_export import tiny

torch.set_num_threads(1)
HW = 64


@pytest.fixture(scope="module")
def models():
    model = build_model(tiny(tconfig.Config(), "gather"), device="cpu")
    params, stats = convert_d2_panoptic_fpn(
        {k: v.numpy() for k, v in model.state_dict().items()})
    jm = JPanopticFPN(tiny(jconfig.Config(), "gather").model)
    images = np.random.RandomState(0).rand(1, HW, HW, 3).astype(np.float32) * 255
    sizes = np.array([[HW, HW]], np.int32)
    return model, jm, {"params": params, "batch_stats": stats}, images, sizes


def test_parameter_counts_equal_the_jax_tree(models):
    model, _, variables, _, _ = models
    params = variables["params"]
    assert analysis.parameter_count(model) == janalysis.parameter_count(params)
    top = analysis.parameter_count_by_module(model, depth=1)
    assert top == {k: janalysis.parameter_count(v) for k, v in params.items()}
    table = analysis.parameter_count_table(model, max_depth=2).splitlines()
    assert table[0].startswith("model") and len(table) > 5
    assert any(r.strip().startswith("roi_heads") for r in table)


def _conv_flops(jaxpr) -> int:
    total = 0
    for eqn in jaxpr.eqns:
        if eqn.primitive.name == "conv_general_dilated":
            out = eqn.outvars[0].aval
            rhs = eqn.invars[1].aval
            dn = eqn.params["dimension_numbers"]
            taps_in = int(np.prod(rhs.shape)) // rhs.shape[dn.rhs_spec[0]]
            total += 2 * int(np.prod(out.shape)) * taps_in // int(
                np.prod(eqn.params["lhs_dilation"]))
        for v in eqn.params.values():
            for sub in (v if isinstance(v, (list, tuple)) else [v]):
                inner = getattr(sub, "jaxpr", sub)
                if hasattr(inner, "eqns"):
                    total += _conv_flops(inner)
    return total


def test_conv_flops_equal_the_jax_jaxpr_and_the_total_is_near_xla(models):
    model, jm, variables, images, sizes = models
    fwd = lambda v, x, s: jm.apply(v, x, s, train=False, combine=True)  # noqa: E731
    jaxpr = jax.make_jaxpr(fwd)(variables, jnp.asarray(images), jnp.asarray(sizes))
    want = _conv_flops(jaxpr.jaxpr)
    got = analysis.flop_count(lambda x, s: model(x, s, combine=True),
                              torch.from_numpy(images), torch.from_numpy(sizes))
    assert got["flops_by_op"]["aten.convolution"] == want > 0
    xla = janalysis.flop_count(fwd, variables, jnp.asarray(images), jnp.asarray(sizes))
    ratio = got["flops"] / xla["flops"]
    assert 0.9 <= ratio <= 1.0, ratio
    assert got["bytes_accessed"] > 0 and xla["bytes_accessed"] > 0


def test_k1_op_counts_its_twins_flops():
    rng = np.random.RandomState(1)
    feats = [torch.from_numpy(rng.randn(1, hw, hw, 16).astype(np.float32))
             for hw in (32, 16, 8, 4)]
    xy = rng.rand(30, 2) * 90
    boxes = torch.from_numpy(np.concatenate([xy, xy + 8 + rng.rand(30, 2) * 30], 1)
                             .astype(np.float32))
    bidx = torch.zeros(30, dtype=torch.int32)
    got = analysis.flop_count(lambda *a: rap.multilevel_roi_align_kernel(*a),
                              feats, boxes, bidx, 7, (4, 8, 16, 32))
    assert got["flops"] == rap.twin_flops(30, 16, 7, 2) > 0
    # the twin, run op by op, does that many multiply-adds in its two contractions
    twin = analysis.flop_count(lambda *a: rap.multilevel_roi_align_ref(*a),
                               feats, boxes, bidx, 7, (4, 8, 16, 32))
    assert twin["flops"] == got["flops"]


def test_find_unused_parameters_reads_the_gradients():
    net = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.Linear(4, 2))
    net[1].weight.requires_grad_(False)
    net[0](torch.ones(1, 3)).sum().backward()
    assert analysis.find_unused_parameters(net) == ["1.bias"]
    with torch.no_grad():
        net[0].bias.grad.zero_()
    assert analysis.find_unused_parameters(net) == ["0.bias", "1.bias"]


def test_analyze_model_prints_the_jax_tools_lines(capsys, monkeypatch):
    monkeypatch.setattr(tconfig, "load_config",
                        lambda *a, **k: tiny(tconfig.Config(), "pallas"))
    res = analyze_model.main(["--device", "cpu", "--height", str(HW), "--width", str(HW)])
    out = capsys.readouterr().out.splitlines()
    assert out[0].startswith("Total parameters: ") and out[0].endswith("M")
    assert any(ln.startswith("Forward FLOPs") and ln.endswith("GFLOPs") for ln in out)
    assert any(ln.startswith("Bytes accessed") and "XLA" in ln for ln in out)
    assert res["parameters"] == sum(res["modules"].values())
    assert "roi_heads.box_head" in res["modules"]
    assert res["flops_by_op"]["u2seg_torch.multilevel_roi_align"] > 0
