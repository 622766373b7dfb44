"""ViTDet Cascade Mask R-CNN in u2seg_torch against the benchmark's plain
reference (``portbench/refvitdet``), on the CPU at a tiny size: dim 64, 4
heads, 6 blocks (the last global) on a 10 x 10 grid with windows of 4 (so the
windows pad), decomposed relative positions, stochastic depth, a two-conv
RPN head and narrow cascade heads with channel LayerNorm. The loss dict,
every gradient and one AdamW step with layer-wise lr decay agree in f32;
the relative positions agree with a loop over (query, key) pairs; the lr
factors with detectron2's ``get_vit_lr_decay_rate``; the stochastic-depth
masks with draws from the step's generator; and the RPN head's and the LN
heads' names and outputs with the layers written out.
"""
import math
import os
import sys

import numpy as np
import pytest
import torch
import torch.nn.functional as F

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from portbench import reference_train as rt  # noqa: E402
from portbench.refvitdet import replay as ref_replay  # noqa: E402
from portbench.refvitdet.config import load_config as ref_load_config  # noqa: E402
from portbench.refvitdet.solver import build_optimizer as ref_optimizer  # noqa: E402
from u2seg_torch.config import load_config  # noqa: E402
from u2seg_torch.engine.train_loop import batch_from_numpy  # noqa: E402
from u2seg_torch.models import vit  # noqa: E402
from u2seg_torch.models.build import build_model  # noqa: E402
from u2seg_torch.solver import build_optimizer, vit_lr_factor  # noqa: E402

SIZE = 160                      # a 10 x 10 grid of 16 x 16 patches
DEPTH = 6

TINY = [
    "model.meta_architecture=GeneralizedRCNN", "model.compute_dtype=float32",
    "model.backbone.name=ViTDet", "model.backbone.vit_dim=64",
    f"model.backbone.vit_depth={DEPTH}", "model.backbone.vit_num_heads=4",
    "model.backbone.vit_window_size=4", f"model.backbone.vit_global_blocks=[{DEPTH - 1}]",
    "model.backbone.vit_use_rel_pos=true", "model.backbone.vit_drop_path_rate=0.4",
    "model.backbone.vit_in_compute_dtype=true",
    "model.fpn.out_channels=16", "model.rpn.head_conv_dims=[-1,-1]",
    "model.rpn.pre_nms_topk_train=64", "model.rpn.post_nms_topk_train=64",
    "model.rpn.batch_size_per_image=32", "model.rpn.nms_thresh=0.7",
    "model.roi_heads.name=CascadeROIHeads", "model.roi_heads.pooler_impl=pallas",
    "model.roi_heads.num_classes=5", "model.roi_heads.batch_size_per_image=32",
    "model.roi_heads.box_head.num_conv=2", "model.roi_heads.box_head.conv_dim=8",
    "model.roi_heads.box_head.num_fc=1", "model.roi_heads.box_head.fc_dim=16",
    "model.roi_heads.box_head.norm=LN", "model.roi_heads.mask_head.num_conv=2",
    "model.roi_heads.mask_head.conv_dim=8", "model.roi_heads.mask_head.norm=LN",
    "model.mask_on=true", f"input.pad_buckets=[[{SIZE},{SIZE}]]",
    "solver.optimizer=AdamW", "solver.weight_decay=0.1",
    "solver.weight_decay_norm=0.0", "solver.no_weight_decay=[pos_embed]",
    "solver.vit_lr_decay_rate=0.8",
    "solver.warmup_iters=250", "solver.clip_gradients=false",
    # the first step at a large lr, so that its change stands above rounding
    "solver.base_lr=0.01", "solver.warmup_factor=1.0",
]


def configs(sdpa: bool):
    """(the port's config, the reference's) of the tiny model."""
    ov = TINY + [f"model.backbone.vit_sdpa={str(sdpa).lower()}"]
    return load_config(None, ov), ref_load_config(ov)


def batch(seed: int = 0, b: int = 2, g: int = 3) -> dict:
    rng = np.random.default_rng(seed)
    x0 = rng.uniform(0, 80, (b, g, 1))
    y0 = rng.uniform(0, 80, (b, g, 1))
    wh = rng.uniform(24, 70, (b, g, 2))
    boxes = np.concatenate([x0, y0, x0 + wh[..., :1], y0 + wh[..., 1:]], -1)
    return {"image": rng.uniform(0, 255, (b, SIZE, SIZE, 3)).astype(np.float32),
            "image_size": np.array([[SIZE, SIZE], [140, 150]][:b], np.int32),
            "gt_boxes": np.minimum(boxes, 139).astype(np.float32),
            "gt_classes": rng.integers(0, 5, (b, g)).astype(np.int32),
            "gt_valid": np.ones((b, g), bool),
            "gt_masks": (rng.random((b, g, 28, 28)) > 0.4).astype(np.float32),
            "sem_seg": np.full((b, SIZE, SIZE), 255, np.int32)}


def both_sides(sdpa: bool, seed: int = 3):
    cfg, ref_cfg = configs(sdpa)
    port = build_model(cfg, device="cpu", seed=seed).train()
    ref = ref_replay.build(ref_cfg, seed, 1.0, "cpu").train()
    return cfg, ref_cfg, port, ref


def losses_of(port, ref, arrays, step_seed: int = 11):
    g1 = torch.Generator().manual_seed(step_seed)
    g2 = torch.Generator().manual_seed(step_seed)
    pb = batch_from_numpy(arrays)
    rb = rt.batch_from_arrays(arrays, "cpu")
    lp = port(pb.images, pb.image_sizes, gt=pb.gt, train=True, generator=g1)
    lr = ref(rb.images, rb.image_sizes, gt=rb.gt, train=True, generator=g2)
    return lp, lr


def test_seeded_weights_and_names_agree():
    _, _, port, ref = both_sides(True)
    ps, rs = port.state_dict(), ref.state_dict()
    assert list(ps) == list(rs)
    for k in ps:
        assert torch.equal(ps[k], rs[k]), k
    names = set(ps)
    assert {"backbone.net.blocks.0.attn.rel_pos_h", "backbone.net.blocks.5.attn.rel_pos_w",
            "proposal_generator.rpn_head.conv.conv0.weight",
            "proposal_generator.rpn_head.conv.conv1.weight",
            "roi_heads.box_head.2.conv1.norm.weight", "roi_heads.mask_head.mask_fcn2.norm.bias"
            } <= names
    # windowed tables span the window, the global block's the grid; all seeded
    assert ps["backbone.net.blocks.0.attn.rel_pos_h"].shape == (7, 16)
    assert ps["backbone.net.blocks.5.attn.rel_pos_h"].shape == (19, 16)
    assert ps["backbone.net.blocks.0.attn.rel_pos_h"].abs().sum() > 0
    assert "roi_heads.box_head.0.conv1.bias" not in names


@pytest.mark.parametrize("sdpa", [True, False])
def test_losses_gradients_and_one_adamw_step_agree(sdpa):
    cfg, ref_cfg, port, ref = both_sides(sdpa)
    arrays = batch()
    lp, lr = losses_of(port, ref, arrays)
    assert set(lp) == set(lr) and "loss_mask" in lp and "loss_box_reg_stage2" in lp
    for k in lp:
        assert abs(float(lp[k]) - float(lr[k])) <= 1e-5 * max(1.0, abs(float(lr[k]))), k
    sum(lp.values()).backward()
    sum(lr.values()).backward()
    rp = dict(ref.named_parameters())
    for n, p in port.named_parameters():
        q = rp[n]
        assert (p.grad is None) == (q.grad is None), n
        if p.grad is not None:
            torch.testing.assert_close(p.grad, q.grad, rtol=1e-4, atol=1e-7, msg=n)
    # the step on the same gradients (an element near Adam's eps would turn
    # the gradients' rounding into a change of a fraction of the lr)
    for n, p in port.named_parameters():
        rp[n].grad = None if p.grad is None else p.grad.clone()
    opt, ropt = build_optimizer(cfg.solver, port), ref_optimizer(ref_cfg.solver, ref)
    before = {n: p.detach().clone() for n, p in port.named_parameters()}
    opt.step()
    ropt.step()
    moved = 0
    for n, p in port.named_parameters():
        torch.testing.assert_close(p, rp[n], rtol=2.5e-7, atol=1e-10, msg=n)
        moved += int(not torch.equal(p, before[n]))
    assert moved > 0.9 * len(before)


def _brute_force_bias(q, hw, rel_h, rel_w):
    h, w = hw
    b, heads, n, d = q.shape
    out = torch.zeros(b, heads, n, n, dtype=q.dtype)
    for qi in range(n):
        a, c = divmod(qi, w)
        for ki in range(n):
            e, f = divmod(ki, w)
            out[:, :, qi, ki] = (q[:, :, qi] @ rel_h[a - e + h - 1]
                                 + q[:, :, qi] @ rel_w[c - f + w - 1])
    return out


@pytest.mark.parametrize("hw", [(4, 4), (3, 5)])
def test_rel_pos_matches_a_loop_over_pairs(hw):
    g = torch.Generator().manual_seed(0)
    h, w = hw
    q = torch.randn(2, 3, h * w, 8, generator=g, dtype=torch.float64)
    rel_h = torch.randn(2 * h - 1, 8, generator=g, dtype=torch.float64)
    rel_w = torch.randn(2 * w - 1, 8, generator=g, dtype=torch.float64)
    got = vit.decomposed_rel_pos(q, hw, rel_h, rel_w)
    torch.testing.assert_close(got, _brute_force_bias(q, hw, rel_h, rel_w))
    with pytest.raises(ValueError):
        vit.get_rel_pos(h + 1, rel_h)


def _d2_lr_decay_rate(name, lr_decay_rate=1.0, num_layers=12):
    """detectron2's ``get_vit_lr_decay_rate``, as published."""
    layer_id = num_layers + 1
    if name.startswith("backbone"):
        if ".pos_embed" in name or ".patch_embed" in name:
            layer_id = 0
        elif ".blocks." in name and ".residual." not in name:
            layer_id = int(name[name.find(".blocks."):].split(".")[2]) + 1
    return lr_decay_rate ** (num_layers + 1 - layer_id)


@pytest.mark.parametrize("name", [
    "backbone.net.pos_embed", "backbone.net.patch_embed.proj.weight",
    "backbone.net.blocks.0.attn.qkv.weight", "backbone.net.blocks.23.mlp.fc2.bias",
    "backbone.net.blocks.11.attn.rel_pos_h", "backbone.simfp_2.0.weight",
    "roi_heads.box_predictor.1.cls_score.weight"])
def test_lr_factors_are_detectron2s(name):
    assert vit_lr_factor(name, 0.8, 24) == _d2_lr_decay_rate(name, 0.8, 24)


def test_adamw_groups_decay_and_factors():
    cfg, _, port, _ = both_sides(True)
    opt = build_optimizer(cfg.solver, port)
    assert type(opt).__name__ == "ScheduledAdamW"
    where = {id(p): g for g in opt.param_groups for p in g["params"]}
    for n, p in port.named_parameters():
        g = where[id(p)]
        assert math.isclose(g["lr_factor"], _d2_lr_decay_rate(n, 0.8, DEPTH)), n
        norm = ".norm" in n or "simfp_2.1." in n
        want = 0.0 if (n.endswith("pos_embed") or norm) else 0.1
        assert g["weight_decay"] == want, n


def test_stochastic_depth_draws_come_from_the_generator():
    torch.manual_seed(0)
    blk = vit.ViTBlock(16, 2, window_size=0, drop_path=0.5).train()
    x = torch.randn(8, 3, 3, 16)
    got = blk(x, torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(5)
    keep_a = torch.empty(8).bernoulli_(0.5, generator=g) / 0.5
    keep_m = torch.empty(8).bernoulli_(0.5, generator=g) / 0.5
    y = x + blk.attn(blk.norm1(x)) * keep_a.view(-1, 1, 1, 1)
    want = y + blk.mlp(blk.norm2(y)) * keep_m.view(-1, 1, 1, 1)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert 0 < int((keep_a == 0).sum()) < 8
    # in eval mode, or at rate 0, nothing is drawn
    g = torch.Generator().manual_seed(5)
    state = g.get_state()
    vit.ViTBlock(16, 2, drop_path=0.0).train()(x, g)
    blk.eval()(x, g)
    assert torch.equal(g.get_state(), state)


@pytest.mark.parametrize("dims", [(-1,), (-1, -1), (12, -1)])
def test_rpn_head_convs(dims):
    from u2seg_torch.models.rpn import RPNHead

    head = RPNHead(8, 3, conv_dims=dims)
    names = [n for n, _ in head.named_parameters()]
    if len(dims) == 1:
        assert names[:2] == ["conv.weight", "conv.bias"]
    else:
        assert names[:4] == ["conv.conv0.weight", "conv.conv0.bias",
                             "conv.conv1.weight", "conv.conv1.bias"]
    x = torch.randn(2, 8, 5, 6)
    logits, deltas = head([x])
    t = x
    for conv in ([head.conv] if len(dims) == 1 else list(head.conv)):
        t = F.relu(F.conv2d(t, conv.weight, conv.bias, padding=1))
    torch.testing.assert_close(logits[0], F.conv2d(t, head.objectness_logits.weight,
                                                   head.objectness_logits.bias))
    torch.testing.assert_close(deltas[0], F.conv2d(t, head.anchor_deltas.weight,
                                                   head.anchor_deltas.bias))
    assert deltas[0].shape == (2, 12, 5, 6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ln_conv_heads(dtype):
    from u2seg_torch.models.roi_heads import FastRCNNConvFCHead, MaskRCNNConvUpsampleHead
    from u2seg_torch.ops.norms import LayerNorm2d, get_norm

    torch.manual_seed(0)
    norm = get_norm("LN", 6)
    assert isinstance(norm, LayerNorm2d) and norm.eps == 1e-6
    with torch.no_grad():
        norm.weight.uniform_(0.5, 1.5)
        norm.bias.uniform_(-0.5, 0.5)
    x = torch.randn(3, 6, 4, 5)
    u = x.mean(1, keepdim=True)
    s = (x - u).pow(2).mean(1, keepdim=True)
    want = (x - u) / torch.sqrt(s + 1e-6) * norm.weight[:, None, None] + norm.bias[:, None, None]
    got = norm(x.to(dtype))
    assert got.dtype == dtype
    torch.testing.assert_close(got.float(), want, rtol=2e-2 if dtype != torch.float32 else 1e-5,
                               atol=5e-2 if dtype != torch.float32 else 1e-5)
    head = FastRCNNConvFCHead(6, 4, num_conv=2, num_fc=1, fc_dim=10, conv_dim=8, norm="LN")
    assert {n for n, _ in head.named_parameters()} == {
        "conv1.weight", "conv1.norm.weight", "conv1.norm.bias", "conv2.weight",
        "conv2.norm.weight", "conv2.norm.bias", "fc1.weight", "fc1.bias"}
    pooled = torch.randn(5, 4, 4, 6)
    t = pooled.permute(0, 3, 1, 2)
    for conv in (head.conv1, head.conv2):
        t = F.relu(conv.norm(F.conv2d(t, conv.weight, None, padding=1)))
    torch.testing.assert_close(head(pooled), F.relu(head.fc1(t.reshape(5, -1))))
    mask = MaskRCNNConvUpsampleHead(6, 3, num_conv=2, conv_dim=8, norm="LN")
    assert mask.mask_fcn1.bias is None and isinstance(mask.mask_fcn2.norm, LayerNorm2d)
