"""The port's utilities (``u2seg_torch/utils``: registry, serialize, file_io,
logger, env, memory, tracing) against the JAX package's modules, on the same
inputs. Exact: every check compares values, call counts or emitted records.
"""
import logging
import os
import pickle
import random

import numpy as np
import pytest
import torch

from u2seg_tpu.utils import env as jenv
from u2seg_tpu.utils import file_io as jfile_io
from u2seg_tpu.utils import logger as jlogger
from u2seg_tpu.utils import memory as jmemory
from u2seg_tpu.utils import registry as jregistry
from u2seg_tpu.utils import serialize as jserialize
from u2seg_tpu.utils import tracing as jtracing
from u2seg_torch.utils import env, file_io, logger, memory, registry, serialize, tracing


@pytest.mark.parametrize("mod", [registry, jregistry], ids=["port", "jax"])
def test_registry_registers_gets_and_refuses_as_the_jax_one(mod):
    reg = mod.Registry("THINGS")

    @reg.register()
    class A:
        pass

    def b():
        return 2

    reg.register(b)
    assert reg.get("A") is A and reg.get("b") is b and "A" in reg
    assert sorted(dict(iter(reg))) == ["A", "b"] == sorted(reg.keys())
    assert repr(reg) == "Registry of THINGS: ['A', 'b']"
    with pytest.raises(ValueError, match="already registered"):
        reg.register(b)
    with pytest.raises(KeyError, match="No object named 'C'"):
        reg.get("C")


def test_locate_resolves_port_paths_as_the_jax_one_resolves_its_own():
    assert registry.locate("u2seg_torch.utils.registry.Registry") is registry.Registry
    assert jregistry.locate("u2seg_tpu.utils.registry.Registry") is jregistry.Registry
    assert (registry.locate("u2seg_torch.config.Config.__init__")
            is __import__("u2seg_torch.config", fromlist=["Config"]).Config.__init__)
    assert registry.locate("numpy.linalg.norm") is jregistry.locate("numpy.linalg.norm")
    for mod, name in ((registry, "u2seg_torch.no_such_module.x"),
                      (jregistry, "u2seg_tpu.no_such_module.x")):
        with pytest.raises(ImportError):
            mod.locate(name)


def test_picklable_wrapper_round_trips_closures_as_the_jax_one():
    k = 7
    for mod in (serialize, jserialize):
        w = mod.PicklableWrapper(mod.PicklableWrapper(lambda x: x * k))
        assert not isinstance(w._obj, mod.PicklableWrapper)
        back = pickle.loads(pickle.dumps(w))
        assert back(3) == 21 and w(3) == 21
        assert mod.PicklableWrapper(np.add).__name__ == "add"


def test_path_manager_matches_the_jax_one(tmp_path, monkeypatch):
    monkeypatch.setenv("U2SEG_CACHE", str(tmp_path / "cache"))
    seen = []
    for mod, tag in ((file_io, "port"), (jfile_io, "jax")):
        pm = mod.PathManager
        uri = f"u2seg://{tag}/a/b.txt"
        assert pm.get_local_path(uri) == str(tmp_path / "cache" / tag / "a" / "b.txt")
        with pm.open(uri, "w") as f:
            f.write("hi")
        assert pm.exists(uri) and pm.isfile(uri) and pm.isdir(f"u2seg://{tag}/a")
        pm.copy(uri, f"u2seg://{tag}/a/c.txt")
        seen.append(pm.ls(f"u2seg://{tag}/a"))
        pm.rm(uri)
        assert not pm.exists(uri)
        assert pm.get_local_path("/plain/path") == "/plain/path"
        with pytest.raises(ValueError):
            pm.register_handler(mod.PathHandler())
    assert seen[0] == seen[1] == ["b.txt", "c.txt"]


class _Records(logging.Handler):
    def __init__(self):
        super().__init__()
        self.messages = []

    def emit(self, record):
        self.messages.append(record.getMessage())


def test_logger_and_its_rate_limits_match_the_jax_one(tmp_path):
    out = {}
    for mod, name in ((logger, "port_log"), (jlogger, "jax_log")):
        lg = mod.setup_logger(output=str(tmp_path / name), name=name, color=False)
        rec = _Records()
        lg.addHandler(rec)
        for i in range(7):
            mod.log_first_n(logging.INFO, "first", n=2, name=name)
            mod.log_every_n(logging.INFO, f"every {i}", n=3, name=name)
            mod.log_every_n_seconds(logging.INFO, f"seconds {i}", n=3600, name=name)
        lg.info("direct")
        for h in lg.handlers:
            h.flush()
        out[mod] = rec.messages
        with open(tmp_path / name / "log.txt") as f:
            assert "direct" in f.read()
        assert lg.propagate is False
    assert out[logger] == out[jlogger] == [
        "first", "every 0", "seconds 0", "first", "every 3", "every 6", "direct"]


def test_seed_all_rng_seeds_numpy_python_and_torch():
    s = env.seed_all_rng(123)
    a = (np.random.rand(3), random.random(), torch.rand(3))
    assert s == jenv.seed_all_rng(123) == 123
    b = (np.random.rand(3), random.random())
    np.testing.assert_array_equal(a[0], b[0])
    assert a[1] == b[1] and os.environ["PYTHONHASHSEED"] == "123"
    env.seed_all_rng(123)
    np.random.rand(3), random.random()
    assert torch.equal(torch.rand(3), a[2])
    drawn = env.seed_all_rng(-1)
    assert 0 <= drawn < 2 ** 31


def test_collect_env_info_names_torch_and_every_kernel_library():
    from u2seg_torch import _cuda

    info = env.collect_env_info()
    assert f"torch: {torch.__version__}" in info and "numpy:" in info
    names = sorted(f[:-3] for f in os.listdir(_cuda.CSRC_DIR) if f.endswith(".cu"))
    assert names == ["roi_align_ml", "roi_align_single", "window_probe"]
    for n in names:
        line = next(ln for ln in info.splitlines() if ln.startswith(f"kernel {n}:"))
        built = os.path.exists(_cuda.library_path(n))
        assert ("not built" not in line) == built and _cuda.library_path(n) in line


def _flaky(times: int, exc):
    calls = []

    def fn(x):
        calls.append(x.device.type if isinstance(x, torch.Tensor) else x)
        if len(calls) <= times:
            raise exc
        return x * 2

    return fn, calls


@pytest.mark.parametrize("times", [1, 2])
def test_retry_if_oom_retries_then_moves_to_the_cpu_as_the_jax_one(times, caplog):
    fn, calls = _flaky(times, torch.cuda.OutOfMemoryError("CUDA out of memory"))
    with caplog.at_level(logging.WARNING, logger=memory.__name__):
        out = memory.retry_if_oom(fn)(torch.ones(2))
    assert torch.equal(out, torch.full((2,), 2.0))
    jfn, jcalls = _flaky(times, RuntimeError("RESOURCE_EXHAUSTED: Out of memory"))
    jout = jmemory.retry_if_oom(jfn)(np.ones(2))
    np.testing.assert_array_equal(np.asarray(jout), np.full(2, 2.0))
    assert len(calls) == len(jcalls) == times + 1
    assert calls[-1] == "cpu"
    warned = [r for r in caplog.records if "retrying on CPU" in r.getMessage()]
    assert len(warned) == (times - 1) and all(r.levelno == logging.WARNING for r in warned)


def test_retry_if_oom_passes_other_errors_through():
    fn, calls = _flaky(5, ValueError("not memory"))
    with pytest.raises(ValueError):
        memory.retry_if_oom(fn)(torch.ones(1))
    assert len(calls) == 1


def test_tracing_helpers_tell_a_trace_from_eager_values():
    import jax

    assert not tracing.is_tracing() and not jtracing.is_tracing()
    assert jax.jit(lambda x: x + jtracing.is_tracing(x))(1.0) == 2.0
    seen = {}

    class M(torch.nn.Module):
        def forward(self, x):
            seen["tracing"] = tracing.is_tracing(x)
            tracing.assert_trace_safe(lambda: bool(x.sum() > 1e9), "never checked")
            return tracing.checkify_nan(x + 1, "x")

    ep = torch.export.export(M(), (torch.zeros(2),), strict=False)
    assert seen["tracing"] is True
    assert torch.equal(ep.module()(torch.ones(2)), torch.full((2,), 2.0))
    from torch._subclasses.fake_tensor import FakeTensorMode

    with FakeTensorMode():
        assert tracing.is_tracing()
    tracing.assert_trace_safe(lambda: True)
    jtracing.assert_trace_safe(lambda: True)
    for mod in (tracing, jtracing):
        with pytest.raises(AssertionError, match="bad"):
            mod.assert_trace_safe(lambda: False, "bad")
    with pytest.warns(UserWarning, match="non-finite values in v"):
        tracing.checkify_nan(torch.tensor([1.0, float("nan")]), "v")
