"""``python -m u2seg_torch.tools.train_net`` (and ``plain_train_net``,
``convert_weights``, ``benchmark --task data``) on the CPU, in this process:
a tiny config (R18-depth bottleneck trunk, narrow widths, SyncBN, cascade,
masks, 7 clusters, 28 sem-seg classes, f32) trains from the files of
``write_synthetic_u2seg_train`` for 3 iterations, resumes to 5, and scores a
``write_synthetic_coco`` val set with ``--eval-only`` on its last
checkpoint; the metrics equal a direct ``run_panoptic_evaluation`` call.

``model.weights``: the JAX package documents it but never reads it (its
predictor and trainer start from seeded weights); the port loads it, in the
trainer (when not resuming) and in the predictor of ``--eval-only``.
"""
import math
import os

import numpy as np
import pytest
import torch

from u2seg_torch.config import load_config
from u2seg_torch.engine import predictor as tpred
from u2seg_torch.engine.checkpoint import load_model_weights, load_reference_state_dict
from u2seg_torch.testing import (
    register_synthetic_coco, write_synthetic_coco, write_synthetic_u2seg_train,
)

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY_YAML = """_BASE_: {base}
model:
  compute_dtype: float32
  resnet: {{depth: 18, width_per_group: 8, stem_out_channels: 16, res2_out_channels: 32}}
  fpn: {{out_channels: 32}}
  rpn: {{pre_nms_topk_train: 64, post_nms_topk_train: 64, pre_nms_topk_test: 64, post_nms_topk_test: 32}}
  roi_heads: {{num_classes: 7, batch_size_per_image: 32, detections_per_image: 10,
              pooler_impl: gather, box_head: {{fc_dim: 64}}, mask_head: {{conv_dim: 32}}}}
  sem_seg_head: {{conv_dim: 32, num_classes: 28}}
  panoptic: {{instance_conf_thresh: 0.1, stuff_area_limit: 64}}
  max_gt_instances: 24
input:
  min_size_train: [64, 80, 96]
  max_size_train: 128
  min_size_test: 64
  max_size_test: 128
  pad_buckets: [[96, 128], [128, 96]]
solver: {{ims_per_batch: 2, max_iter: 3, checkpoint_period: 2, warmup_iters: 2}}
dataloader: {{num_workers: 2}}
datasets: {{cluster_num: 7, train: [u2seg_7_train_panoptic_separated]}}
test: {{render_canvas: [80, 80], render_max_runs: 8192, raw_buckets: [[80, 80]], ims_per_batch: 2}}
"""
VAL = "train_net_synthetic_val"


@pytest.fixture(scope="module")
def setup_files(tmp_path_factory):
    root = tmp_path_factory.mktemp("train_net")
    cfg_file = root / "tiny.yaml"
    cfg_file.write_text(TINY_YAML.format(
        base=os.path.join(ROOT, "configs/COCO-PanopticSegmentation/u2seg_R50_800.yaml")))
    data = str(root / "datasets")
    write_synthetic_u2seg_train(data, [(60, 80), (48, 64), (80, 60), (64, 48)], 7, seed=0)
    val = write_synthetic_coco(str(root / "val"), ((40, 80), (80, 40)) * 2,
                               np.random.RandomState(12), cluster_num=800)
    register_synthetic_coco(VAL, val)
    return str(cfg_file), data, root


def _argv(cfg_file, data, out, *extra):
    return ["--config-file", cfg_file, "--device", "cpu", *extra,
            f"datasets.root={data}", f"output_dir={out}"]


def _same(a, b):
    if isinstance(a, dict):
        assert set(a) == set(b)
        for k in a:
            _same(a[k], b[k])
    else:
        assert (math.isnan(a) and math.isnan(b)) or a == b


def test_train_resume_and_eval_only(setup_files, monkeypatch):
    from u2seg_torch.tools import train_net

    cfg_file, data, root = setup_files
    out = str(root / "out")
    tr = train_net.main(_argv(cfg_file, data, out))
    assert tr.iter == 3 and tr.state.step == 3
    losses = [v for v, _ in tr.storage.history("total_loss").values()]
    assert len(losses) == 3 and all(np.isfinite(losses))
    assert tr.checkpointer.get_checkpoint_file() == "model_0000002"

    tr2 = train_net.main(_argv(cfg_file, data, out, "--resume", "--max-iter", "5"))
    assert tr2.start_iter == 3 and tr2.iter == 5 and tr2.state.step == 5
    assert all(np.isfinite([v for v, _ in tr2.storage.history("total_loss").values()]))
    ckpt = os.path.join(out, tr2.checkpointer.get_checkpoint_file())
    assert ckpt.endswith("model_0000004")

    built = []
    real = tpred.DefaultPredictor

    def recording(cfg, model=None, device=None):
        p = real(cfg, model=model, device=device)
        built.append(p)
        return p

    monkeypatch.setattr(tpred, "DefaultPredictor", recording)
    overrides = [f"model.weights={ckpt}", f"datasets.test=[{VAL}]", "datasets.cluster_num=800"]
    res = train_net.main(_argv(cfg_file, data, str(root / "eval"), "--eval-only",
                               "--eval-mode", "auto") + overrides)
    saved = load_reference_state_dict(ckpt)
    sd = built[0].model.state_dict()
    assert set(saved) == set(sd) and all(torch.equal(sd[k], saved[k]) for k in sd)

    cfg = load_config(cfg_file, [f"datasets.root={data}"] + overrides)
    direct = tpred.run_panoptic_evaluation(cfg, "auto", device="cpu",
                                           matching_dir=str(root / "direct"))
    assert set(res) == {VAL} and "sem_seg" in res[VAL]
    _same(res, direct)


def test_plain_train_net_trains_and_checkpoints(setup_files):
    from u2seg_torch.tools import plain_train_net

    cfg_file, data, root = setup_files
    out = root / "plain"
    state = plain_train_net.main(_argv(cfg_file, data, str(out), "--max-iter", "2"))
    assert state.step == 2
    assert (out / "model_0000001").exists() and (out / "metrics.json").exists()


def test_benchmark_data_times_the_train_loader(setup_files):
    from u2seg_torch.tools import benchmark

    cfg_file, data, _ = setup_files
    res = benchmark.main(["--task", "data", "--iters", "3", "--config-file", cfg_file,
                          f"datasets.root={data}"])
    assert res["images_per_sec"] > 0 and res["num_workers"] == 2


def _tiny(cfg_file, **kw):
    cfg = load_config(cfg_file)
    for k, v in kw.items():
        setattr(cfg.model, k, v)
    return cfg


def test_model_weights_load_where_the_jax_package_ignores_them(setup_files, tmp_path):
    """The JAX predictor builds on a ``model.weights`` path that does not
    exist: it never reads it. The port's predictor, given a port
    checkpoint of other weights (seed 5), holds the file's tensors and
    answers as a predictor built on that model."""
    from u2seg_tpu.config.config import load_config as jload_config
    from u2seg_tpu.engine import predictor as jpred
    from u2seg_torch.models.build import build_model

    cfg_file, _, _ = setup_files
    jcfg = jload_config(cfg_file, [f"model.weights={tmp_path / 'no_such_file.pth'}"])
    assert jpred.DefaultPredictor(jcfg).variables["params"]

    other = build_model(_tiny(cfg_file), device="cpu", seed=5)
    path = str(tmp_path / "weights.pth")
    torch.save({"model": other.state_dict(), "iteration": 7}, path)
    with pytest.raises(FileNotFoundError):
        tpred.DefaultPredictor(_tiny(cfg_file, weights=str(tmp_path / "no_such_file.pth")),
                               device="cpu")
    cfg = _tiny(cfg_file, weights=path)
    pred = tpred.DefaultPredictor(cfg, device="cpu")
    sd = pred.model.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in other.state_dict().items())
    img = (np.random.RandomState(0).rand(60, 80, 3) * 255).astype(np.uint8)
    got = pred(img)
    ref = tpred.DefaultPredictor(_tiny(cfg_file), model=other.eval(), device="cpu")(img)
    np.testing.assert_array_equal(got["panoptic"], ref["panoptic"])
    np.testing.assert_array_equal(got["instances"]["boxes"], ref["instances"]["boxes"])


def test_trainer_loads_model_weights_unless_resuming(setup_files, tmp_path):
    from u2seg_torch.engine.train_loop import DefaultTrainer
    from u2seg_torch.models.build import build_model
    from u2seg_torch.testing import fake_loader

    cfg_file, _, _ = setup_files
    other = build_model(_tiny(cfg_file), device="cpu", seed=9)
    path = str(tmp_path / "w.pth")
    torch.save(other.state_dict(), path)                  # a bare state dict
    cfg = _tiny(cfg_file, weights=path)
    cfg.output_dir = str(tmp_path / "out")
    tr = DefaultTrainer(cfg, fake_loader(np.random.RandomState(0), b=2), device="cpu")
    assert tr.resume_or_load(resume=True) is False        # nothing to resume from
    sd = tr.model.state_dict()
    assert all(torch.equal(sd[k], v) for k, v in other.state_dict().items())


def test_weight_files_are_checked_and_converted(setup_files, tmp_path, caplog):
    """A detectron2 .pkl (numpy arrays, BN step counters, pixel statistics)
    converts and loads; a missing tensor is logged; an unknown name, a
    wrong shape or other pixel statistics raise."""
    import pickle

    from u2seg_torch.models.build import build_model
    from u2seg_torch.tools import convert_weights

    cfg_file, _, _ = setup_files
    cfg = _tiny(cfg_file)
    src = build_model(cfg, device="cpu", seed=3).state_dict()
    d2 = {k: v.numpy() for k, v in src.items()}
    d2["backbone.bottom_up.stem.conv1.norm.num_batches_tracked"] = np.array(7)
    d2["pixel_mean"] = np.asarray(cfg.model.pixel_mean).reshape(3, 1, 1)
    d2["pixel_std"] = np.asarray(cfg.model.pixel_std).reshape(3, 1, 1)
    dropped = "sem_seg_head.predictor.bias"
    del d2[dropped]
    pkl = str(tmp_path / "model_final.pkl")
    with open(pkl, "wb") as f:
        pickle.dump({"model": d2, "__author__": "d2"}, f)
    out = convert_weights.main(["--config-file", cfg_file, "--input", pkl,
                                "--output", str(tmp_path / "w.pth")])
    model = build_model(cfg, device="cpu", seed=0)
    info = load_model_weights(model, out)
    assert info["missing"] == [dropped] and dropped in caplog.text
    sd = model.state_dict()
    assert all(torch.equal(sd[k], src[k]) for k in src if k != dropped)

    for bad, match in ((dict(d2, **{"roi_heads.extra.weight": np.zeros(3)}), "lacks"),
                       (dict(d2, **{"sem_seg_head.predictor.weight": np.zeros((2, 2))}),
                        "shape"),
                       (dict(d2, pixel_mean=np.zeros((3, 1, 1))), "pixel_mean")):
        with open(pkl, "wb") as f:
            pickle.dump({"model": bad}, f)
        with pytest.raises(ValueError, match=match):
            load_model_weights(build_model(cfg, device="cpu"), pkl)


def test_two_ranks_train_from_their_own_shards(setup_files):
    """``--num-devices 2``: two gloo processes, each with its own loader
    (the sampler sharded by rank, ims_per_batch / 2 images a step); rank 0
    writes the checkpoints and metrics."""
    import json

    from u2seg_torch.tools import train_net

    cfg_file, data, root = setup_files
    out = root / "two_ranks"
    assert train_net.main(["--config-file", cfg_file, "--device", "cpu", "--num-devices", "2",
                           "--max-iter", "2", f"datasets.root={data}", f"output_dir={out}",
                           "solver.ims_per_batch=4"]) is None
    assert (out / "model_0000001").exists()
    lines = [json.loads(l) for l in (out / "metrics.json").read_text().splitlines()]
    assert lines[-1]["iteration"] == 1 and np.isfinite(lines[-1]["total_loss"])


def test_the_configured_sampler_is_used(setup_files, monkeypatch):
    """The JAX train_net always builds the default TrainingSampler; the port
    honours ``dataloader.sampler``."""
    from u2seg_torch.data import loader
    from u2seg_torch.tools import train_net

    cfg_file, data, _ = setup_files
    made = []

    class Recording(loader.RepeatFactorTrainingSampler):
        def __init__(self, *a, **k):
            made.append(a[1])
            super().__init__(*a, **k)

    monkeypatch.setattr(loader, "RepeatFactorTrainingSampler", Recording)
    cfg = load_config(cfg_file, [f"datasets.root={data}", "dataloader.num_workers=0",
                                 "dataloader.sampler=RepeatFactorTrainingSampler",
                                 "dataloader.repeat_threshold=0.3"])
    assert next(iter(train_net.build_train_loader(cfg)))["image"].shape[0] == 2
    assert made == [0.3]
    cfg.dataloader.sampler = "NoSuchSampler"
    with pytest.raises(ValueError, match="NoSuchSampler"):
        train_net.build_train_loader(cfg)


def test_a_flag_after_the_overrides_is_refused(setup_files, tmp_path):
    from u2seg_torch.tools import train_net

    cfg_file, data, _ = setup_files
    with pytest.raises(ValueError, match="--max-iter"):
        train_net.main(["--config-file", cfg_file, "--device", "cpu",
                        f"output_dir={tmp_path}", "--max-iter", "2"])
