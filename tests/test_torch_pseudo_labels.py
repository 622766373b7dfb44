"""The pseudo-label slice as a whole: the JAX script (``tools/generate_pseudo_labels.py``)
and the port's (``python -m u2seg_torch.tools.generate_pseudo_labels --device
cpu``) on one ``testing.write_synthetic_pseudo_inputs`` set, every stage,
with equal outputs.

Both scripts' DINO is patched to the same narrow ViT (dim 64, depth 2, 4
heads, patch 16) and both load one seeded state dict in DINO's names from a
``.pth`` (its 14 x 14 position embedding resized to the 4 x 4 grid of 64 px
crops). The port's k-means++ draw is replaced, in this test only, by the
JAX package's draw for the same seed (``_kmeans_pp_init`` of
``u2seg_tpu/pseudo/kmeans.py``); everything after it is the port's own. The
decode, selection, class-aware, panoptic and super JSONs must be equal, and
the panoptic and stuff PNGs equal byte for byte.
"""
import functools
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from u2seg_tpu.pseudo import dino as jdino
from u2seg_tpu.pseudo import kmeans as jkm
from u2seg_torch.pseudo import dino as tdino
from u2seg_torch.pseudo import kmeans as tkm
from u2seg_torch.testing import write_synthetic_pseudo_inputs
from u2seg_torch.tools import generate_pseudo_labels as tool

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NARROW = dict(dim=64, depth=2, num_heads=4)
SEED, CLUSTERS = 3, 6
SIZES = [(60, 80), (64, 48), (80, 60), (48, 64), (70, 90), (90, 70)]


def jax_script():
    spec = importlib.util.spec_from_file_location(
        "jax_generate_pseudo_labels", os.path.join(ROOT, "tools", "generate_pseudo_labels.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def flags(ds, weights, out):
    return ["--num-clusters", str(CLUSTERS), "--seed", str(SEED),
            "--crops-dir", ds.crops_dir, "--dino-weights", weights, "--crop-size", "64",
            "--batch-size", "8", "--knn", "5", "--kmeans-iters", "10",
            "--decode-json", os.path.join(out, "decode.json"),
            "--select-json", os.path.join(out, "select.json"),
            "--instances-json", ds.instances_json,
            "--output-json", os.path.join(out, "curated.json"),
            "--stego-dir", ds.stego_dir,
            "--panoptic-dir", os.path.join(out, "panoptic"),
            "--panoptic-json", os.path.join(out, "panoptic.json"),
            "--stuff-dir", os.path.join(out, "stuff"),
            "--gt-panoptic-json", ds.gt_panoptic_json,
            "--super-json", os.path.join(out, "super.json")]


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("pseudo"))
    ds = write_synthetic_pseudo_inputs(os.path.join(root, "data"), SIZES,
                                       instances_per_image=5, seed=1)
    model = tdino.seeded_dino_state(tdino.DinoViT(**NARROW, img_size=224), seed=7)
    weights = os.path.join(root, "dino.pth")
    torch.save(model.state_dict(), weights)
    return root, ds, weights


def load(path):
    with open(path) as f:
        return json.load(f)


def test_port_tool_equals_the_jax_script(inputs, monkeypatch):
    root, ds, weights = inputs
    outs = {}
    # the JAX script, narrow DINO
    monkeypatch.setattr(jdino, "DinoViT", functools.partial(jdino.DinoViT, **NARROW))
    monkeypatch.setattr(jdino, "convert_dino_vit",
                        functools.partial(jdino.convert_dino_vit, depth=NARROW["depth"]))
    jmod = jax_script()
    outs["jax"] = os.path.join(root, "jax")
    os.makedirs(outs["jax"])
    for stage in ("all", "supergt"):
        monkeypatch.setattr(sys, "argv", ["x", "--stage", stage] + flags(ds, weights, outs["jax"]))
        jmod.main()
    # the port's tool, narrow DINO, the JAX package's k-means++ draw
    monkeypatch.setattr(tdino, "DinoViT", functools.partial(tdino.DinoViT, **NARROW))

    def jax_seeding(x, k, metric, generator):
        return torch.from_numpy(np.array(jkm._kmeans_pp_init(
            jax.random.PRNGKey(SEED), jnp.asarray(x.numpy()), k, metric)))

    monkeypatch.setattr(tkm, "_kmeans_pp_init", jax_seeding)
    outs["port"] = os.path.join(root, "port")
    os.makedirs(outs["port"])
    res = {}
    for stage in ("all", "supergt"):
        res.update(tool.main(["--stage", stage, "--device", "cpu"]
                             + flags(ds, weights, outs["port"])))
    assert sorted(res) == ["assign", "cluster", "panoptic", "stuff", "supergt"]
    assert res["cluster"]["crops"] == len(ds.keys) == 30

    j, p = outs["jax"], outs["port"]
    decode = load(os.path.join(p, "decode.json"))
    assert sorted(decode) == ds.keys
    assert set(decode.values()) <= set(range(CLUSTERS)) and len(set(decode.values())) > 1
    for name in ("decode.json", "select.json", "curated.json", "panoptic.json", "super.json"):
        assert load(os.path.join(p, name)) == load(os.path.join(j, name)), name
    assert len(load(os.path.join(p, "select.json"))["selected_keys"]) > 1
    for sub in ("panoptic", "stuff"):
        names = sorted(os.listdir(os.path.join(j, sub)))
        assert names == sorted(os.listdir(os.path.join(p, sub))) and len(names) == len(SIZES)
        for n in names:
            with open(os.path.join(j, sub, n), "rb") as a, open(os.path.join(p, sub, n), "rb") as b:
                assert a.read() == b.read(), (sub, n)


def test_smoke_mode_clusters_every_crop(inputs, monkeypatch):
    """No ``--dino-weights``: seeded random weights, as the JAX smoke mode."""
    root, ds, _ = inputs
    monkeypatch.setattr(tdino, "DinoViT", functools.partial(tdino.DinoViT, **NARROW))
    out = os.path.join(root, "smoke.json")
    res = tool.main(["--stage", "cluster", "--device", "cpu", "--crops-dir", ds.crops_dir,
                     "--crop-size", "32", "--num-clusters", "4", "--kmeans-iters", "3",
                     "--decode-json", out])
    decode = load(out)
    assert sorted(decode) == ds.keys and set(decode.values()) <= set(range(4))
    assert res["cluster"]["crops"] == 30 and res["cluster"]["read_s"] > 0
