"""u2seg_torch's data parallelism over two gloo processes on the CPU, held
against the JAX package's ``shard_map`` step on a 2-device CPU mesh.

Two workers (``tests/torch_dist_worker.py``: pure torch, one thread each, a
``file://`` rendezvous under ``tmp_path``) run the comm helpers, one SyncBN
layer and the data-parallel train step; meanwhile this process computes the
JAX side.

- comm: ``all_gather``, ``gather``, ``reduce_dict``, ``shared_random_seed``,
  ``all_reduce_mean_`` and ``broadcast_`` beyond one process (counterpart of
  ``tests/parallel/test_comm.py``).
- SyncBN alone: a (2, 8, 6, 5) input, one image per rank, against flax's
  ``BatchNorm(axis_name="data")`` inside ``shard_map``: output, running
  statistics, and the gradients of ``sum(y * cotangent)`` w.r.t. the input,
  weight and bias (summed over the ranks) at rtol 1e-5, atol 1e-6 * max.
- The dry run: ``entry.dryrun_multichip(2)`` (its own two processes, run
  beside the workers) prints finite metrics of one update.
- The step: the small config of ``tests/test_torch_train_step.py`` with
  ``norm="SyncBN"``, f32, RNG-free sampling (every candidate taken), global
  b=2, two steps, against the JAX ``make_train_step(model, tx,
  create_mesh(2))`` from the same weights (``convert_d2_panoptic_fpn``).
  The JAX step averages losses that each replica normalised on its own
  batch, and the port does the same, so the parity target is the 2-device
  JAX step, not a 1-process step on the combined batch. Tolerances are that
  file's: losses rtol 1e-4; BN running statistics rtol 1e-3, atol 1e-4 *
  max; each parameter's change <= 0.1 * max|change|. Parameters, buffers and
  momentum are bit-identical on the two ranks.
"""
import ast
import dataclasses
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.shard_map import shard_map
from jax.sharding import PartitionSpec as P

from test_torch_train_step import LOSS_KEYS, _np_tree, _rel_err, randomize, tiny
from u2seg_tpu.config import config as jconfig
from u2seg_tpu.config import testing as jtesting
from u2seg_tpu.engine.checkpoint import convert_d2_panoptic_fpn
from u2seg_tpu.engine.trainer import TrainState as JTrainState
from u2seg_tpu.engine.trainer import make_train_step as jmake_train_step
from u2seg_tpu.models.panoptic_fpn import PanopticFPN as JPanopticFPN
from u2seg_tpu.ops.norms import BatchNorm as JBatchNorm
from u2seg_tpu.parallel.mesh import create_mesh as jcreate_mesh
from u2seg_tpu.solver import build_optimizer as jbuild_optimizer
from u2seg_torch import config as tconfig
from u2seg_torch import entry
from u2seg_torch.models.build import build_model
from u2seg_torch.weights import from_jax

torch.set_num_threads(1)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORKER = os.path.join(ROOT, "tests", "torch_dist_worker.py")
WORLD, STEPS = 2, 2


def syncbn_inputs():
    rng = np.random.RandomState(4)
    x = (rng.randn(2, 5, 8, 6) * 2 + 1).astype(np.float32)      # NCHW
    return dict(x=x, ct=rng.randn(*x.shape).astype(np.float32),
                weight=rng.uniform(0.5, 1.5, 5).astype(np.float32),
                bias=(rng.randn(5) * 0.1).astype(np.float32))


def jax_syncbn(inp):
    mesh = jcreate_mesh(WORLD)
    bn = JBatchNorm(momentum=0.9, epsilon=1e-5, axis_name="data")
    x = jnp.array(inp["x"].transpose(0, 2, 3, 1))
    ct = jnp.array(inp["ct"].transpose(0, 2, 3, 1))
    params = {"scale": jnp.array(inp["weight"]), "bias": jnp.array(inp["bias"])}
    stats = {"mean": jnp.zeros(5), "var": jnp.ones(5)}

    def body(params, x, ct):
        def loss(params, x):
            y, upd = bn.apply({"params": params, "batch_stats": stats}, x,
                              use_running_average=False, mutable=["batch_stats"])
            return jnp.sum(y * ct), (y, upd["batch_stats"])

        (_, (y, new)), (gp, gx) = jax.value_and_grad(
            loss, argnums=(0, 1), has_aux=True)(params, x)
        return y, new, jax.lax.psum(gp, "data"), gx

    fn = jax.jit(shard_map(body, mesh=mesh, in_specs=(P(), P("data"), P("data")),
                           out_specs=(P("data"), P(), P(), P("data")),
                           check_rep=False))
    y, new, gp, gx = fn(params, x, ct)
    nchw = lambda a: np.asarray(a).transpose(0, 3, 1, 2)
    return dict(y=nchw(y), gx=nchw(gx), gw=np.asarray(gp["scale"]),
                gb=np.asarray(gp["bias"]), mean=np.asarray(new["mean"]),
                var=np.asarray(new["var"]))


def step_setup():
    cfg_t, cfg_j = tiny(tconfig.Config()), tiny(jconfig.Config())
    for cfg in (cfg_t, cfg_j):
        cfg.model.resnet.norm = cfg.model.fpn.norm = "SyncBN"
    model = randomize(build_model(cfg_t, device="cpu"), np.random.RandomState(0))
    sd0 = {k: v.clone() for k, v in model.state_dict().items()}
    jb = jtesting.tiny_batch(np.random.RandomState(2), b=WORLD)
    soft = np.random.RandomState(99).rand(*np.asarray(jb.gt.masks).shape).astype(np.float32)
    jb = dataclasses.replace(jb, gt=dataclasses.replace(jb.gt, masks=jnp.array(soft)))
    batch = dict(images=np.asarray(jb.images), image_sizes=np.asarray(jb.image_sizes),
                 boxes=np.asarray(jb.gt.boxes), classes=np.asarray(jb.gt.classes),
                 valid=np.asarray(jb.gt.valid), masks=soft.copy(),
                 sem_seg=np.asarray(jb.sem_seg))
    return cfg_t, cfg_j, sd0, jb, batch


def jax_steps(cfg_j, sd0, jb):
    params, stats = convert_d2_panoptic_fpn({k: v.numpy() for k, v in sd0.items()})
    tx = jbuild_optimizer(cfg_j.solver)
    step = jmake_train_step(JPanopticFPN(cfg_j.model), tx, jcreate_mesh(WORLD),
                            donate=False)
    state = JTrainState(step=jnp.zeros((), jnp.int32), params=params,
                        batch_stats=stats, opt_state=tx.init(params))
    rows = []
    for i in range(STEPS):
        state, metrics = step(state, jb, jax.random.PRNGKey(i))
        rows.append(dict(metrics={k: float(v) for k, v in metrics.items()},
                         params=_np_tree(state.params), stats=_np_tree(state.batch_stats)))
    return rows, from_jax(_np_tree(state.params), _np_tree(state.batch_stats)), int(state.step)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("ddp")
    cfg_t, cfg_j, sd0, jb, batch = step_setup()
    sb = syncbn_inputs()
    in_file = str(tmp / "inputs.pt")
    torch.save({"syncbn": {k: torch.from_numpy(v) for k, v in sb.items()},
                "step": dict(cfg=cfg_t, state=sd0, batch=batch, steps=STEPS)}, in_file)
    init = "file://" + str(tmp / "rendezvous")
    env = dict(os.environ, PYTHONPATH=ROOT + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, WORKER, str(r), str(WORLD), init, in_file,
                               str(tmp)], cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(WORLD)]
    pool = ThreadPoolExecutor(1)
    try:
        dryrun = pool.submit(entry.dryrun_multichip, WORLD, 240)
        ref_bn = jax_syncbn(sb)                   # the JAX side, while the ranks run
        ref_rows, ref_final, ref_count = jax_steps(cfg_j, sd0, jb)
        outs = [p.communicate(timeout=240)[0] for p in procs]
        dryrun_out = dryrun.result(timeout=240)
    finally:
        pool.shutdown(wait=True)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    got = [torch.load(str(tmp / f"rank{r}.pt"), weights_only=False) for r in range(WORLD)]
    return dict(got=got, ref_bn=ref_bn, ref_rows=ref_rows, ref_final=ref_final,
                ref_count=ref_count, sd0=sd0, sb=sb, dryrun=dryrun_out)


def test_comm_across_two_ranks(runs):
    for i, r in enumerate(runs["got"]):
        assert r["world"] == 2 and r["rank"] == i and r["is_main"] == (i == 0)
        assert [g["rank"] for g in r["all_gather"]] == [0, 1]
        assert len(r["all_gather"][1]["blob"]) == 407
        assert r["reduce_mean"] == {"loss": 1.5}
        assert r["reduce_sum"] == {"n": 3.0}
        assert torch.equal(r["mean_a"], torch.full((2, 3), 1.5))
        assert torch.equal(r["mean_b"], torch.arange(4, dtype=torch.float32) * 1.5)
        assert torch.equal(r["broadcast"][0], torch.ones(3))
        assert torch.equal(r["broadcast"][1], torch.ones(2, dtype=torch.int64))
    assert runs["got"][0]["gather"] == [0, 1] and runs["got"][1]["gather"] == []
    assert runs["got"][0]["seed"] == runs["got"][1]["seed"]


def _close(got, ref, rtol=1e-5):
    ref = np.asarray(ref)
    np.testing.assert_allclose(np.asarray(got), ref, rtol=rtol,
                               atol=1e-6 * max(float(np.abs(ref).max()), 1e-30))


def test_syncbn_layer_matches_flax_under_shard_map(runs):
    ref, got = runs["ref_bn"], [r["syncbn"] for r in runs["got"]]
    _close(torch.cat([g["y"] for g in got]), ref["y"])
    _close(torch.cat([g["gx"] for g in got]), ref["gx"])
    _close(got[0]["gw"] + got[1]["gw"], ref["gw"])
    _close(got[0]["gb"] + got[1]["gb"], ref["gb"])
    for g in got:
        _close(g["mean"], ref["mean"])
        _close(g["var"], ref["var"])
    # SyncBN's moments are the combined batch's: the output equals BN over
    # both images at once
    x = torch.from_numpy(runs["sb"]["x"])
    mean = x.mean(dim=(0, 2, 3), keepdim=True)
    var = x.var(dim=(0, 2, 3), unbiased=False, keepdim=True)
    w = torch.from_numpy(runs["sb"]["weight"]).view(1, -1, 1, 1)
    b = torch.from_numpy(runs["sb"]["bias"]).view(1, -1, 1, 1)
    _close(torch.cat([g["y"] for g in got]), (x - mean) / torch.sqrt(var + 1e-5) * w + b,
           rtol=1e-4)


@pytest.mark.parametrize("i", range(STEPS))
def test_two_rank_step_losses_match_jax_shard_map(runs, i):
    ref = runs["ref_rows"][i]["metrics"]
    for r in runs["got"]:
        got = r["step"]["rows"][i]["metrics"]
        assert sorted(got) == sorted(ref) == sorted(LOSS_KEYS + ["total_loss"])
        for k in ref:
            assert np.isfinite(got[k])
            np.testing.assert_allclose(got[k], ref[k], rtol=1e-4, err_msg=f"step {i} {k}")


@pytest.mark.parametrize("i", range(STEPS))
def test_two_rank_bn_running_stats_match_jax(runs, i):
    ref = from_jax(runs["ref_rows"][i]["params"], runs["ref_rows"][i]["stats"])
    got = runs["got"][0]["step"]["rows"][i]["stats"]
    assert len(got) == 2 * 37
    for k, v in got.items():
        r = ref[k].numpy()
        np.testing.assert_allclose(v.numpy(), r, rtol=1e-3,
                                   atol=1e-4 * float(np.abs(r).max()), err_msg=k)
        assert not torch.equal(v, runs["sd0"][k]), f"{k} did not move"


def test_two_rank_parameter_changes_match_jax(runs):
    assert runs["ref_count"] == STEPS and runs["got"][0]["step"]["count"] == STEPS
    final = runs["got"][0]["step"]["final"]
    worst = 0.0
    for k, v in final.items():
        if "running_" in k:
            continue
        d_ref = (runs["ref_final"][k] - runs["sd0"][k]).numpy()
        d_got = (v - runs["sd0"][k]).numpy()
        assert float(np.abs(d_ref).max()) > 0, f"{k} did not move"
        err = _rel_err(d_got, d_ref)
        worst = max(worst, err)
        assert err <= 0.1, f"{k}: {err:.2e} of max|change|"
    print(f"worst parameter-change error {worst:.2e} of max|change|")


def test_ranks_hold_bit_identical_state(runs):
    a, b = (r["step"] for r in runs["got"])
    assert a["final"].keys() == b["final"].keys()
    for k in a["final"]:
        assert torch.equal(a["final"][k], b["final"][k]), k
    for ma, mb in zip(a["momentum"], b["momentum"]):
        assert torch.equal(ma, mb)
    for ra, rb in zip(a["rows"], b["rows"]):
        assert ra["metrics"] == rb["metrics"]


def test_dryrun_multichip_prints_finite_metrics(runs):
    line = [l for l in runs["dryrun"].splitlines()
            if l.startswith(f"dryrun_multichip({WORLD}): ok")]
    assert len(line) == 1, runs["dryrun"]
    metrics = ast.literal_eval(line[0].split(" - ", 1)[1])
    assert sorted(metrics) == sorted(LOSS_KEYS + ["total_loss"])
    assert all(np.isfinite(v) for v in metrics.values())
