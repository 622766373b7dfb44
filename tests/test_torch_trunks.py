"""The ViT, Swin, MViT and RegNet trunks of u2seg_torch and their pyramids vs
the JAX package, on the CPU, and the places where both differ from
detectron2 on purpose.

Each case builds the backbone of both packages from one tiny config
(``build_backbone``: ViTDet, SwinFPN, MViTFPN, RegNetFPN; inputs whose
sides are multiples of 32, as the FPN's top-down sums need), draws the JAX
variable tree from numpy (``torch_zoo_parity.random_variables``), loads the
same numbers into the port through ``weights.from_jax`` with a strict
``load_state_dict``, and runs both on one numpy batch (b=2). Compared: the
trunk's own outputs (flax's captured intermediates against a forward hook)
and every pyramid level; in the RegNet BN case (train mode) also the moved
running statistics.

- ViT: windowed and global blocks, a 10x14 token grid padded to 12x15 by
  the 3x3 windows; the SimpleFeaturePyramid's p2-p6.
- Swin: shifted blocks on 16x24 stage-0 maps (window 3: padded to 18x24)
  and on 2x3 stage-3 maps smaller than a window.
- MViT: q and kv strides, a width change per stage.
- RegNet: grouped convs, FrozenBN in eval mode and BN in train mode.

Tolerances (f32): rtol 1e-4 with atol 1e-4 * max|ref| for every level and
statistic. What that leaves room for: flax's LayerNorm takes the variance as
E[x^2] - E[x]^2, torch's in two passes; at these widths and values (O(1)
means and spreads) the two differ by a few f32 ulps of the normalized
output, far under the bound. bf16 (the dtype test): the levels in the JAX
package's dtypes (ViTDet f32 throughout, the trunk+FPN bf16 out of the FPN)
at the AMP tolerance.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from torch_zoo_parity import AMP_ATOL, AMP_RTOL, close, random_variables
from u2seg_tpu.config import config as jconfig
from u2seg_tpu.models.backbone import build_backbone as jbackbone
from u2seg_tpu.models.swin import SwinBlock as JSwinBlock
from u2seg_torch import config as tconfig
from u2seg_torch.models import swin as tswin
from u2seg_torch.models.backbone import build_backbone
from u2seg_torch.models.build import build_model
from u2seg_torch.weights import from_jax

torch.set_num_threads(1)

REGNET = dict(regnet_w_a=8.0, regnet_w_0=8, regnet_w_m=2.0, regnet_depth=6,
              regnet_group_width=8)
# name -> (backbone, backbone fields, (H, W), trunk norm, train)
CASES = {
    "vit": ("ViTDet", dict(vit_patch_size=4, vit_dim=32, vit_depth=3, vit_num_heads=2,
                           vit_window_size=3, vit_global_blocks=(1,)), (40, 56), None, False),
    "swin": ("SwinFPN", dict(embed_dim=16, depths=(2, 2, 2, 2), trunk_num_heads=(1, 2, 2, 2),
                             window_size=3), (64, 96), None, False),
    "mvit": ("MViTFPN", dict(embed_dim=16, depths=(1, 2, 1, 1),
                             trunk_num_heads=(1, 1, 2, 2)), (64, 96), None, False),
    "regnet_frozen_bn": ("RegNetFPN", REGNET, (64, 96), "FrozenBN", False),
    "regnet_bn_train": ("RegNetFPN", REGNET, (64, 96), "BN", True),
}


def configs(case, dtype="float32"):
    name, fields, _, norm, train = CASES[case]
    out = []
    for cfg in (jconfig.Config(), tconfig.Config()):
        m = cfg.model
        m.compute_dtype = dtype
        m.backbone.name = name
        for k, v in fields.items():
            setattr(m.backbone, k, v)
        m.fpn.out_channels = 16
        m.fpn.norm = "BN" if train else ""
        if norm:
            m.resnet.norm = norm
        out.append(cfg)
    return out


def images(case, seed=0):
    h, w = CASES[case][2]
    return np.random.RandomState(seed).randn(2, h, w, 3).astype(np.float32)


def port_backbone(v, cfg, hw):
    bb = build_backbone(cfg.model, input_hw=hw)
    sd = from_jax({"backbone": v["params"]}, {"backbone": v.get("batch_stats", {})})
    bb.load_state_dict({k[len("backbone."):]: t for k, t in sd.items()})
    return bb


def trunk_of(bb):
    return bb.net if hasattr(bb, "net") else bb.bottom_up


def run_both(case, dtype="float32"):
    cfg_j, cfg_t = configs(case, dtype)
    train = CASES[case][4]
    x = images(case)
    jdt = jnp.dtype(dtype)
    jm = jbackbone(cfg_j.model, dtype=jdt)
    v = random_variables(jm, 3, jnp.asarray(x), train=False)
    mutable = ["intermediates"] + (["batch_stats"] if train else [])
    ref, state = jax.jit(lambda v, x: jm.apply(
        v, x, train=train, capture_intermediates=True, mutable=mutable))(
        jax.tree_util.tree_map(jnp.asarray, v), jnp.asarray(x).astype(jdt))
    trunk_key = "vit" if "vit" in state["intermediates"] else "trunk"
    ref_trunk = state["intermediates"][trunk_key]["__call__"][0]

    bb = port_backbone(v, cfg_t, x.shape[1:3]).train(train)
    seen = {}
    trunk_of(bb).register_forward_hook(lambda m, i, o: seen.setdefault("trunk", o))
    xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(getattr(torch, dtype))
    got = bb(xt)
    return dict(ref=ref, got=got, ref_trunk=ref_trunk, trunk=seen["trunk"], bb=bb,
                state=state, v=v)


@pytest.mark.parametrize("case", sorted(CASES))
def test_trunk_and_pyramid_match_jax(case):
    r = run_both(case)
    ref_t, got_t = r["ref_trunk"], r["trunk"]
    if case == "vit":
        assert got_t.shape == (2, 10, 14, 32)
        close(got_t, ref_t["last_feat"], name="last_feat")
    else:
        assert sorted(got_t) == sorted(ref_t) == ["res2", "res3", "res4", "res5"]
        for k in ref_t:
            close(got_t[k].permute(0, 2, 3, 1), ref_t[k], name=k)
    assert sorted(r["got"]) == sorted(r["ref"]) == ["p2", "p3", "p4", "p5", "p6"]
    for k, ref in r["ref"].items():
        got = r["got"][k]
        assert got.dtype == torch.float32, k
        close(got.permute(0, 2, 3, 1), ref, name=k)
    if case == "regnet_bn_train":
        moved = from_jax({"backbone": r["v"]["params"]},
                         {"backbone": r["state"]["batch_stats"]})
        sd = r["bb"].state_dict()
        keys = [k for k in moved if k.endswith(("running_mean", "running_var"))]
        assert len(keys) > 20
        for k in keys:
            close(sd[k[len("backbone."):]], moved[k].numpy(), name=k)


@pytest.mark.parametrize("case", ["vit", "swin"])
def test_bf16_levels_keep_the_jax_dtypes(case):
    """Under a bf16 compute dtype the JAX package runs ViTDet in f32 (no
    dtype given: flax promotes the bf16 image to the f32 parameters) and a
    trunk in f32 with its FPN in bf16; the port does the same."""
    r = run_both(case, "bfloat16")
    for k, ref in r["ref"].items():
        got = r["got"][k]
        want = torch.float32 if ref.dtype == jnp.float32 else torch.bfloat16
        assert got.dtype == want, (k, got.dtype, ref.dtype)
        ref = np.asarray(ref.astype(jnp.float32))
        np.testing.assert_allclose(got.detach().float().permute(0, 2, 3, 1).numpy(), ref,
                                   rtol=AMP_RTOL, atol=AMP_ATOL * np.abs(ref).max(), err_msg=k)
    assert {r["ref"][k].dtype for k in r["ref"]} == (
        {jnp.dtype("float32")} if case == "vit" else {jnp.dtype("bfloat16")})


# ---------------------------------------------------------------------------
# Differences from detectron2 that both packages share
# ---------------------------------------------------------------------------

def test_vit_pos_embed_is_made_for_the_build_grid():
    """``pos_embed`` is (1, gh, gw, dim) for the grid of the size the model
    is built for; another grid raises in both packages. ``build_model``
    builds for ``input.pad_buckets[0]``: 1024x1024 / 16 for the ViTDet
    file."""
    r = run_both("vit")
    bb, v = r["bb"], r["v"]
    assert tuple(bb.net.pos_embed.shape) == (1, 10, 14, 32)
    other = np.zeros((1, 48, 56, 3), np.float32)
    with pytest.raises(ValueError, match=r"\(12, 14\) token grid.*made for \(10, 14\)"):
        bb(torch.from_numpy(other).permute(0, 3, 1, 2))
    jm = jbackbone(configs("vit")[0].model)
    with pytest.raises(Exception, match="pos_embed"):
        jm.apply(jax.tree_util.tree_map(jnp.asarray, v), jnp.asarray(other))
    from u2seg_torch import model_zoo

    cfg = model_zoo.get_config("ViTDet/mask_rcnn_vitdet_b_100ep.yaml")
    cfg.model.backbone.vit_depth = 1
    assert tuple(build_model(cfg, device="cpu").backbone.net.pos_embed.shape) == (1, 64, 64, 768)
    with pytest.raises(ValueError, match="input_hw"):
        build_backbone(cfg.model)


def _d2_order(blk, x):
    """detectron2's shifted block: pad first, roll the padded map, mask on
    the padded size, crop after rolling back."""
    ws, s = blk.window_size, blk.shift
    b, h, w, c = x.shape
    y = blk.norm1(x)
    y = F.pad(y, (0, 0, 0, (-w) % ws, 0, (-h) % ws))
    hp, wp = y.shape[1:3]
    y = torch.roll(y, (-s, -s), dims=(1, 2))
    wins, _ = tswin.window_partition(y, ws)
    mask = torch.from_numpy(tswin._shift_mask(hp, wp, ws, s))
    wins = blk.attn(wins.reshape(-1, ws * ws, c), mask)
    y = tswin.window_unpartition(wins.view(-1, ws, ws, c), ws, (hp, wp), (hp, wp))
    y = torch.roll(y, (s, s), dims=(1, 2))[:, :h, :w]
    x = x + y
    return x + blk.mlp(blk.norm2(x))


def test_swin_rolls_the_unpadded_map_as_the_jax_package():
    """On a 5x7 map with 3x3 windows (shift 1) the JAX order (roll, then
    pad) and detectron2's (pad, then roll) give different blocks; the port
    gives the JAX package's."""
    x = np.random.RandomState(4).randn(2, 5, 7, 8).astype(np.float32)
    jblk = JSwinBlock(8, 2, window_size=3, shift=1)
    v = random_variables(jblk, 5, jnp.asarray(x))
    ref = np.asarray(jax.jit(jblk.apply)(jax.tree_util.tree_map(jnp.asarray, v), jnp.asarray(x)))
    blk = tswin.SwinBlock(8, 2, window_size=3, shift=1)
    sd = from_jax({"backbone": {"trunk": {"patch_embed": {"kernel": np.zeros((4, 4, 3, 8))},
                                          "patch_norm": {"scale": np.ones(8), "bias": np.zeros(8)},
                                          "stage0_block1": v["params"]}}}, {})
    pre = "backbone.bottom_up.layers.0.blocks.1."
    blk.load_state_dict({k[len(pre):]: t for k, t in sd.items() if k.startswith(pre)})
    xt = torch.from_numpy(x)
    with torch.no_grad():
        got, d2 = blk(xt), _d2_order(blk, xt)
    close(got, ref, name="JAX order")
    scale = float(np.abs(ref).max())
    assert float((d2 - torch.from_numpy(ref)).abs().max()) > 1e-2 * scale
