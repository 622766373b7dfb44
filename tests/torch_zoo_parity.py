"""Shared helpers of the detector-family parity tests (``test_torch_rcnn*.py``,
``test_torch_dense_detector.py``, ``test_torch_keypoints.py``): tiny configs
of both packages, JAX variable trees drawn from numpy, and the comparisons.

Weights. The JAX module's variable shapes come from ``jax.eval_shape`` of its
``init`` (traced, not compiled) and every leaf is drawn from a numpy seed:
kernels with std sqrt(1 / fan_in) (the box regressors ``bbox_pred`` and
``anchor_deltas`` 10x smaller, so decoded boxes stay near their anchors),
biases and BN means N(0, 0.1), norm scales and BN variances U(0.5, 1.5), the
transformer trunks' ``pos_embed`` and ``rel_pos_bias`` tables N(0, 0.5). The
levels then stay O(1) through the trunk. The port loads the same numbers
through ``weights.from_jax`` with a strict ``load_state_dict``. Classifiers
at that scale are the score calibration of these tests: the packages' own
inits (0.01-std weights, the 0.01 prior bias of the dense heads) leave every
class probability near uniform or near 0.01, below the 0.05 test threshold,
and decoding and NMS would go unexercised.

Tolerances (f32): boxes, scores and keypoint coordinates rtol 1e-4 with atol
1e-4 * max|ref|; classes and validity exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import torch

from u2seg_torch.weights import from_jax

AMP_RTOL, AMP_ATOL = 0.05, 0.03


def tiny(cfg, meta="GeneralizedRCNN", **over):
    """A narrow config of either package: bottleneck trunk of 8 blocks,
    32-channel FPN, 7 box classes, 5 dense / stuff classes, f32, the gather
    pooler; ``over`` sets dotted paths under ``cfg.model``."""
    m = cfg.model
    m.meta_architecture = meta
    m.compute_dtype = "float32"
    m.resnet.depth = 18                 # (2, 2, 2, 2) bottleneck blocks
    m.resnet.width_per_group = 8
    m.resnet.stem_out_channels = 16
    m.resnet.res2_out_channels = 32
    m.fpn.out_channels = 32
    m.rpn.pre_nms_topk_test = 200
    m.rpn.post_nms_topk_test = 100
    rh = m.roi_heads
    rh.num_classes = 7
    rh.box_head.fc_dim = 64
    rh.box_head.conv_dim = 32
    rh.mask_head.conv_dim = 32
    rh.keypoint_head.conv_dims = (16, 16)
    rh.detections_per_image = 20
    rh.pooler_impl = "gather"
    m.sem_seg_head.conv_dim = 32
    m.sem_seg_head.num_classes = 5
    m.retinanet.num_classes = 5
    m.fcos.num_classes = 5
    for path, value in over.items():
        obj = m
        *parents, leaf = path.split(".")
        for p in parents:
            obj = getattr(obj, p)
        setattr(obj, leaf, value)
    # the heads read their own task flags
    rh.mask_on, rh.keypoint_on = m.mask_on, m.keypoint_on
    return cfg


# box regressors: small, so decoded boxes stay near their anchors
_DELTA_HEADS = ("bbox_pred", "anchor_deltas")
# ViT's position embedding and Swin's relative position bias: large enough
# that a wrong index or grid shows
_TABLES = ("pos_embed", "rel_pos_bias")


def random_variables(module, seed, *args, **kwargs):
    """The variable tree of ``module.init(key, *args, **kwargs)``, every leaf
    drawn from numpy (see the module doc)."""
    shapes = jax.eval_shape(
        lambda: module.init({"params": jax.random.PRNGKey(0)}, *args, **kwargs))
    rng = np.random.RandomState(seed)

    def fill(path, leaf):
        name, shape = path[-1].key, leaf.shape
        if name == "kernel":
            std = np.sqrt(1.0 / np.prod(shape[:-1]))
            if path[-2].key in _DELTA_HEADS:
                std *= 0.1
            return (rng.randn(*shape) * std).astype(np.float32)
        if name in ("bias", "mean"):
            return (rng.randn(*shape) * 0.1).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.5, 1.5, shape).astype(np.float32)
        if name in _TABLES:
            return (rng.randn(*shape) * 0.5).astype(np.float32)
        raise KeyError(f"unexpected leaf {name}")

    tree = jax.tree_util.tree_map_with_path(fill, shapes)
    return {k: _plain(v) for k, v in tree.items()}


def _plain(tree):
    return {k: _plain(v) for k, v in tree.items()} if hasattr(tree, "items") else tree


def port_from(variables, model):
    """Load ``variables`` into the port's ``model`` (strict) and return it."""
    model.load_state_dict(from_jax(variables["params"], variables.get("batch_stats", {})))
    return model


def jnp_tree(tree):
    return jax.tree_util.tree_map(jnp.asarray, tree)


def numpy_of(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy() if x.is_floating_point() else x.detach().numpy()
    return np.asarray(x)


def close(got, ref, rtol=1e-4, name=""):
    ref = np.asarray(ref, np.float64)
    atol = 1e-4 * max(float(np.abs(ref).max(initial=0.0)), 1e-30)
    np.testing.assert_allclose(numpy_of(got), ref, rtol=rtol, atol=atol, err_msg=name)


def exact(got, ref, name=""):
    np.testing.assert_array_equal(numpy_of(got), np.asarray(ref), err_msg=name)


def same_detections(got, ref):
    """``Detections`` of the port vs the JAX package at the f32 tolerances;
    returns the number of valid detections."""
    exact(got.valid, ref.valid, "valid")
    exact(got.classes, ref.classes, "classes")
    close(got.boxes, ref.boxes, name="boxes")
    close(got.scores, ref.scores, name="scores")
    for field in ("mask_logits", "keypoints"):
        g, r = getattr(got, field), getattr(ref, field)
        assert (g is None) == (r is None), field
        if field == "keypoints" and g is not None:
            close(g[..., :2], r[..., :2], name="keypoint x, y")
    return int(np.asarray(ref.valid).sum())


def matched_share(got, ref, px: float = 1.0) -> float:
    """Share of the JAX package's valid detections that the port has too:
    the same class and every box side within ``px`` pixels (bf16 runs,
    where a near tie may resolve the other way)."""
    rb, rc, rv = (np.asarray(ref.boxes, np.float64), np.asarray(ref.classes),
                  np.asarray(ref.valid))
    gb, gc, gv = numpy_of(got.boxes), numpy_of(got.classes), numpy_of(got.valid)
    hits = total = 0
    for i in range(rb.shape[0]):
        for j in np.flatnonzero(rv[i]):
            total += 1
            near = (np.abs(gb[i] - rb[i, j]).max(-1) <= px) & (gc[i] == rc[i, j]) & gv[i]
            hits += bool(near.any())
    return hits / max(total, 1)
