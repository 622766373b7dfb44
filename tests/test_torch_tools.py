"""The port's visualize tools, LazyConfig and ``lazyconfig_train_net``
against the JAX package's (``tools/visualize_data.py``,
``tools/visualize_json_results.py``, ``u2seg_tpu/config/lazy.py``), on the
CPU, on synthetic files written by ``u2seg_torch.testing``.

- ``visualize_data`` (both sources) and ``visualize_json_results``: the same
  images under the same names, equal on every pixel outside the labels'
  text boxes (the JAX tools draw text with ``cv2.putText``;
  ``test_torch_visualizer.py`` holds the text). The images are compared as
  handed to the writer (the JAX tools write through ``cv2.imwrite``, the
  port through Pillow: two JPEG encoders).
- ``LazyConfig.load / apply_overrides / save / instantiate``: equal dicts,
  equal saved files, equal built objects. Exact.
- ``lazyconfig_train_net``: 2 steps of a tiny config with ``--device cpu``,
  finite losses; ``--eval-only`` scores ``datasets.test`` (the JAX tool
  parses the flag and trains) with the metrics of a direct
  ``run_panoptic_evaluation`` call.
"""
import importlib.util
import json
import math
import os

import numpy as np
import pytest
import torch

from u2seg_tpu.config import lazy as jlazy
from u2seg_torch import lazy
from u2seg_torch.evaluation import rle as rle_codec
from u2seg_torch.testing import write_synthetic_coco, write_synthetic_u2seg_train
from u2seg_torch.tools import lazyconfig_train_net, visualize_data, visualize_json_results

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BASE = os.path.join(ROOT, "configs/COCO-PanopticSegmentation/u2seg_R50_800.yaml")
CLUSTERS = 13
DATASET = f"u2seg_{CLUSTERS}_train_panoptic_separated"
VIS_YAML = f"""_BASE_: {BASE}
input: {{min_size_train: [64, 80, 96], max_size_train: 128, pad_buckets: [[96, 128], [128, 96]]}}
datasets: {{cluster_num: {CLUSTERS}, train: [{DATASET}]}}
"""
TRAIN_YAML = f"""_BASE_: {BASE}
model:
  compute_dtype: float32
  resnet: {{depth: 18, width_per_group: 8, stem_out_channels: 16, res2_out_channels: 32}}
  fpn: {{out_channels: 32}}
  rpn: {{pre_nms_topk_train: 64, post_nms_topk_train: 64}}
  roi_heads: {{num_classes: {CLUSTERS}, batch_size_per_image: 32, pooler_impl: gather,
              box_head: {{fc_dim: 64}}, mask_head: {{conv_dim: 32}}}}
  sem_seg_head: {{conv_dim: 32, num_classes: 28}}
  max_gt_instances: 24
input: {{min_size_train: [64, 80, 96], max_size_train: 128, pad_buckets: [[96, 128], [128, 96]]}}
solver: {{ims_per_batch: 2, max_iter: 5, checkpoint_period: 10, warmup_iters: 2}}
dataloader: {{num_workers: 1}}
datasets: {{cluster_num: {CLUSTERS}, train: [{DATASET}]}}
test: {{render_canvas: [80, 80], render_max_runs: 8192, raw_buckets: [[80, 80]], ims_per_batch: 2}}
"""
VAL = "tools_synthetic_val"


def load_jax_tool(name):
    spec = importlib.util.spec_from_file_location(
        f"jax_{name}", os.path.join(ROOT, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    root = tmp_path_factory.mktemp("tools")
    data = str(root / "datasets")
    write_synthetic_u2seg_train(data, [(60, 80), (48, 64), (80, 60), (64, 48)], CLUSTERS,
                                seed=1)
    (root / "vis.yaml").write_text(VIS_YAML)
    (root / "train.yaml").write_text(TRAIN_YAML)
    return root, data


def jax_writes(monkeypatch):
    """Capture what the JAX tools hand to ``cv2.imwrite`` (as RGB)."""
    import cv2

    written = {}
    monkeypatch.setattr(cv2, "imwrite", lambda path, img: written.__setitem__(
        os.path.basename(path), np.ascontiguousarray(img[:, :, ::-1])) or True)
    return written


def assert_same_images(port, jax_images):
    assert sorted(os.path.basename(w["path"]) for w in port) == sorted(jax_images)
    for w in port:
        ref = jax_images[os.path.basename(w["path"])]
        keep = np.ones(ref.shape[:2], bool)
        for x0, y0, x1, y1 in w["text_boxes"]:
            keep[max(y0, 0):max(y1 + 1, 0), max(x0, 0):max(x1 + 1, 0)] = False
        assert w["image"].shape == ref.shape and keep.mean() > 0.3
        np.testing.assert_array_equal(w["image"][keep], ref[keep])
        assert os.path.exists(w["path"])


@pytest.mark.parametrize("source", ["annotation", "dataloader"])
def test_visualize_data_draws_as_the_jax_tool(files, tmp_path, monkeypatch, source):
    root, data = files
    args = ["--config-file", str(root / "vis.yaml"), "--source", source,
            "--dataset", DATASET, "--max-images", "3"]
    opts = [f"datasets.root={data}"]
    written = jax_writes(monkeypatch)
    monkeypatch.setattr("sys.argv", ["visualize_data.py", *args, "--output-dir",
                                     str(tmp_path / "jax"), *opts])
    load_jax_tool("visualize_data").main()
    port = visualize_data.main([*args, "--output-dir", str(tmp_path / "port"), *opts])
    assert len(port) == 3 and all(len(w["text_boxes"]) > 0 for w in port)
    assert_same_images(port, written)


def test_visualize_json_results_draws_as_the_jax_tool(tmp_path, monkeypatch):
    rng = np.random.RandomState(7)
    coco = write_synthetic_coco(str(tmp_path / "coco"), [(60, 80), (80, 60), (64, 64)], rng,
                                cluster_num=CLUSTERS)
    with open(coco.instances_json) as f:
        gt = json.load(f)
    preds = []
    for a in gt["annotations"]:
        img = next(i for i in gt["images"] if i["id"] == a["image_id"])
        x, y, w, h = a["bbox"]
        mask = np.zeros((img["height"], img["width"]), np.uint8)
        mask[int(y):int(y + h), int(x):int(x + w)] = 1
        r = rle_codec.encode(mask)
        r["counts"] = r["counts"].decode("ascii")
        preds.append({"image_id": a["image_id"], "category_id": a["category_id"],
                      "bbox": a["bbox"], "score": float(rng.rand()), "segmentation": r})
    pred_json = tmp_path / "pred.json"
    pred_json.write_text(json.dumps(preds))
    args = ["--input", str(pred_json), "--dataset-json", coco.instances_json,
            "--image-root", coco.image_dir, "--conf-threshold", "0.3"]
    written = jax_writes(monkeypatch)
    monkeypatch.setattr("sys.argv", ["visualize_json_results.py", *args, "--output",
                                     str(tmp_path / "jax")])
    load_jax_tool("visualize_json_results").main()
    port = visualize_json_results.main([*args, "--output", str(tmp_path / "port")])
    assert len(port) == 3
    assert_same_images(port, written)


LAZY_CFG = """
import fractions
from u2seg_torch.lazy import LazyCall

half = LazyCall(fractions.Fraction)(numerator=1, denominator=2)
model = dict(depth=50, widths=[64, 128], head=LazyCall("collections.OrderedDict")(a=1),
             ratio=half)
train = dict(max_iter=100, output_dir="./out", lr=0.02)
"""


def test_lazy_config_matches_the_jax_module(tmp_path):
    path = tmp_path / "cfg.py"
    path.write_text(LAZY_CFG)
    got, ref = lazy.LazyConfig.load(str(path)), jlazy.LazyConfig.load(str(path))
    assert got == ref and sorted(got) == ["LazyCall", "half", "model", "train"]
    overrides = ["train.max_iter=7", "model.widths=[8, 16]", "train.output_dir=/tmp/x",
                 "model.depth=18"]
    lazy.LazyConfig.apply_overrides(got, overrides)
    jlazy.LazyConfig.apply_overrides(ref, overrides)
    assert got == ref and got["train"]["max_iter"] == 7
    lazy.LazyConfig.save(got, str(tmp_path / "port.py"))
    jlazy.LazyConfig.save(ref, str(tmp_path / "jax.py"))
    assert (tmp_path / "port.py").read_text() == (tmp_path / "jax.py").read_text()
    built, jbuilt = lazy.instantiate(got), jlazy.instantiate(ref)
    assert built == jbuilt
    assert built["model"]["ratio"] == 0.5 and list(built["model"]["head"].items()) == [("a", 1)]
    assert lazy.locate("u2seg_torch.lazy.LazyConfig") is lazy.LazyConfig
    with pytest.raises(TypeError):
        lazy.LazyCall(3)


def test_lazyconfig_train_net_takes_two_steps(files, tmp_path):
    root, data = files
    out = tmp_path / "out"
    cfg = tmp_path / "lazy_train.py"
    cfg.write_text(
        "from u2seg_torch.config import load_config\n"
        "from u2seg_torch.lazy import LazyCall\n"
        f"base = LazyCall(load_config)(path={str(root / 'train.yaml')!r}, "
        f"overrides=['datasets.root={data}'])\n"
        f"train = dict(max_iter=5, output_dir={str(out)!r})\n")
    state = lazyconfig_train_net.main(["--config-file", str(cfg), "--device", "cpu",
                                       "train.max_iter=2"])
    assert state.step == 2
    with open(out / "metrics.json") as f:
        lines = [json.loads(ln) for ln in f if ln.strip()]
    assert lines[-1]["iteration"] == 1 and math.isfinite(lines[-1]["total_loss"])
    from u2seg_torch.engine.checkpoint import Checkpointer

    assert Checkpointer(str(out)).get_checkpoint_file() == "model_0000001"


def test_lazyconfig_train_net_eval_only_scores_the_test_sets(files, tmp_path, monkeypatch):
    from u2seg_torch.config import load_config
    from u2seg_torch.engine.predictor import run_panoptic_evaluation
    from u2seg_torch.testing import register_synthetic_coco

    root, data = files
    val = write_synthetic_coco(str(tmp_path / "val"), ((40, 80), (80, 40)),
                               np.random.RandomState(12), cluster_num=800)
    register_synthetic_coco(VAL, val)
    overrides = [f"datasets.root={data}", f"datasets.test=[{VAL}]", "datasets.cluster_num=800"]
    cfg = tmp_path / "lazy_eval.py"
    cfg.write_text(
        "from u2seg_torch.config import load_config\n"
        "from u2seg_torch.lazy import LazyCall\n"
        f"base = LazyCall(load_config)(path={str(root / 'train.yaml')!r}, overrides={overrides!r})\n")
    monkeypatch.chdir(tmp_path)
    res = lazyconfig_train_net.main(["--config-file", str(cfg), "--device", "cpu", "--eval-only"])
    direct = run_panoptic_evaluation(load_config(str(root / "train.yaml"), overrides),
                                     device="cpu", matching_dir=str(tmp_path / "direct"))
    assert set(res) == {VAL} and "sem_seg" in res[VAL]
    assert json.dumps(res, sort_keys=True) == json.dumps(direct, sort_keys=True)
