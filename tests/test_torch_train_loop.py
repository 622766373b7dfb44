"""u2seg_torch's hook-driven training loop on the CPU, in one process.

``DefaultTrainer`` on the small config of ``tests/test_torch_train_step.py``
(8-block trunk, narrow widths, 7 classes, cascade, masks, f32, "BN") over
``testing.fake_loader`` batches (b=2, 64x64): it trains with its default
hooks and writes ``metrics.json`` and checkpoints; four steps in one run
equal two steps, a checkpoint, a fresh trainer's resume and two more, bit for
bit (parameters, buffers, momentum, update count); its first step equals a
bare ``make_train_step`` call on the same batch and generator, bit for bit.
``auto_scale_workers`` and ``batch_from_numpy`` are held against the JAX
package's.
"""
import json
import os

import numpy as np
import pytest
import torch

from test_torch_train_step import tiny
from u2seg_tpu.config import config as jconfig
from u2seg_tpu.engine.train_loop import auto_scale_workers as jauto_scale_workers
from u2seg_tpu.engine.train_loop import batch_from_numpy as jbatch_from_numpy
from u2seg_torch import config as tconfig
from u2seg_torch.engine.train_loop import (
    DefaultTrainer, auto_scale_workers, batch_from_numpy,
)
from u2seg_torch.engine.trainer import create_train_state, make_train_step, sampling_seed
from u2seg_torch.testing import fake_loader
from test_torch_model import jax_view

torch.set_num_threads(1)


def small_cfg(out_dir, checkpoint_period=2):
    cfg = tiny(tconfig.Config())
    cfg.output_dir = str(out_dir)
    cfg.solver.checkpoint_period = checkpoint_period
    return cfg


def batches(n, seed=2):
    loader = fake_loader(np.random.RandomState(seed), b=2)
    return [next(loader) for _ in range(n)]


def full_state(trainer):
    opt = trainer.optimizer
    return (trainer.model.state_dict(),
            [opt.state[p]["momentum_buffer"] for p in trainer.model.parameters()],
            trainer.state.step)


def test_trainer_trains_with_its_hooks_and_writes_metrics_and_checkpoints(tmp_path):
    cfg = small_cfg(tmp_path)
    trainer = DefaultTrainer(cfg, batches(3), device="cpu")
    trainer.register_hooks(trainer.build_hooks())
    trainer.train(max_iter=3)
    assert trainer.iter == 3 and trainer.state.step == 3
    hist = trainer.storage.history("total_loss")
    assert len(hist.values()) == 3 and np.isfinite(hist.latest())
    assert trainer.storage.history("lr").latest() == pytest.approx(
        trainer.schedule(2), rel=1e-12)
    lines = [json.loads(l) for l in open(tmp_path / "metrics.json")]
    assert [l["iteration"] for l in lines] == [2]          # period 20: the last step
    assert np.isfinite(lines[0]["total_loss"]) and "lr" in lines[0]
    assert trainer.checkpointer.has_checkpoint()
    assert trainer.checkpointer.get_checkpoint_file() == "model_0000002"
    assert os.path.exists(tmp_path / "model_0000001")
    saved = trainer.checkpointer.load("model_0000002")
    assert saved["iteration"] == 2
    for k, v in trainer.model.state_dict().items():
        assert torch.equal(saved["model"][k], v), k


def test_four_steps_equal_two_then_resume_then_two(tmp_path):
    data = batches(4)
    straight = DefaultTrainer(small_cfg(tmp_path / "a", 10), data, device="cpu")
    straight.register_hooks(straight.build_hooks())
    straight.train(max_iter=4)

    first = DefaultTrainer(small_cfg(tmp_path / "b", 10), data[:2], device="cpu")
    first.register_hooks(first.build_hooks())
    first.train(max_iter=2)                 # saves model_0000001 as the last step
    second = DefaultTrainer(small_cfg(tmp_path / "b", 10), data[2:], device="cpu")
    second.register_hooks(second.build_hooks())
    assert second.resume_or_load(resume=True)
    assert second.start_iter == 2 and second.state.step == 2
    for k, v in first.model.state_dict().items():
        assert torch.equal(second.model.state_dict()[k], v), k
    second.train(max_iter=4)
    assert second.iter == 4

    sd_a, mom_a, count_a = full_state(straight)
    sd_b, mom_b, count_b = full_state(second)
    assert count_a == count_b == 4
    for k in sd_a:
        assert torch.equal(sd_a[k], sd_b[k]), k
    for a, b in zip(mom_a, mom_b):
        assert torch.equal(a, b)
    assert (straight.storage.history("total_loss").values()[2:]
            == second.storage.history("total_loss").values())


def test_first_step_equals_a_bare_train_step(tmp_path):
    cfg = small_cfg(tmp_path)
    raw = batches(1)
    trainer = DefaultTrainer(cfg, raw, device="cpu")
    trainer.train(max_iter=1)
    got = {k: h.latest() for k, h in trainer.storage.histories().items()}

    state = create_train_state(cfg, device="cpu", seed=0)
    step = make_train_step(state.model, state.optimizer)
    gen = torch.Generator().manual_seed(sampling_seed(1, 0, 0))
    ref = {k: float(v) for k, v in step(batch_from_numpy(raw[0]), gen).items()}
    assert got == ref
    for k, v in state.model.state_dict().items():
        assert torch.equal(trainer.model.state_dict()[k], v), k


@pytest.mark.parametrize("workers", [1, 2, 8, 16])
def test_auto_scale_workers_matches_jax(workers):
    got = auto_scale_workers(tconfig.Config(), workers).solver
    ref = jauto_scale_workers(jconfig.Config(), workers).solver
    assert jax_view(tconfig.to_dict(got), "solver.") == jconfig.to_dict(ref)
    if workers == 8:
        assert got == tconfig.Config().solver


def test_batch_from_numpy_round_trips_fake_loader_dicts():
    raw = batches(1, seed=5)[0]
    got, ref = batch_from_numpy(raw), jbatch_from_numpy(raw)
    pairs = [(got.images, raw["image"], ref.images),
             (got.image_sizes, raw["image_size"], ref.image_sizes),
             (got.gt.boxes, raw["gt_boxes"], ref.gt.boxes),
             (got.gt.classes, raw["gt_classes"], ref.gt.classes),
             (got.gt.valid, raw["gt_valid"], ref.gt.valid),
             (got.gt.masks, raw["gt_masks"], ref.gt.masks),
             (got.sem_seg, raw["sem_seg"], ref.sem_seg)]
    for t, a, r in pairs:
        assert t.dtype == torch.from_numpy(a).dtype
        np.testing.assert_array_equal(t.numpy(), a)
        np.testing.assert_array_equal(t.numpy(), np.asarray(r))
    no_sem = {k: v for k, v in raw.items() if k != "sem_seg"}
    assert torch.equal(batch_from_numpy(no_sem).sem_seg,
                       torch.zeros(raw["image"].shape[:3], dtype=torch.int32))
