"""``u2seg_torch.tools.prepare_ade20k_sem_seg`` against the repo's
``tools/prepare_ade20k_sem_seg.py`` (loaded by path, run with ``sys.argv``
patched): both on copies of one tree of small ADE20k-style label PNGs; every
file they write is equal byte for byte."""
import importlib.util
import os
import shutil

import numpy as np
import pytest

from u2seg_torch.data.image_io import read_sem_seg, write_png
from u2seg_torch.tools import prepare_ade20k_sem_seg as port_tool

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_tool():
    spec = importlib.util.spec_from_file_location(
        "jax_prepare_ade20k", os.path.join(ROOT, "tools", "prepare_ade20k_sem_seg.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _tree(root):
    rng = np.random.RandomState(0)
    for split, n in (("training", 3), ("validation", 2)):
        d = os.path.join(root, "annotations", split)
        os.makedirs(d)
        for i in range(n):
            lab = rng.randint(0, 151, (17 + i, 23 + 2 * i)).astype(np.uint8)
            lab[0, :3] = (0, 1, 150)
            write_png(os.path.join(d, f"ADE_{split}_{i:08d}.png"), lab)


def test_port_tool_writes_the_same_files(tmp_path, monkeypatch):
    _tree(str(tmp_path / "jax"))
    shutil.copytree(tmp_path / "jax", tmp_path / "port")
    monkeypatch.setattr("sys.argv", ["prepare_ade20k_sem_seg.py", "--root", str(tmp_path / "jax")])
    _jax_tool().main()
    written = port_tool.main(["--root", str(tmp_path / "port")])
    assert len(written) == 5
    for path in written:
        rel = os.path.relpath(path, tmp_path / "port")
        with open(path, "rb") as a, open(tmp_path / "jax" / rel, "rb") as b:
            assert a.read() == b.read(), rel
    lab = read_sem_seg(str(tmp_path / "port" / "annotations" / "training" / "ADE_training_00000000.png"))
    out = read_sem_seg(written[0])
    np.testing.assert_array_equal(out, port_tool.convert(lab))
    assert out[0, :3].tolist() == [255, 0, 149]


@pytest.mark.parametrize("label,want", [(0, 255), (1, 0), (150, 149)])
def test_convert_maps_unlabeled_to_ignore(label, want):
    assert port_tool.convert(np.array([[label]], np.uint8)).tolist() == [[want]]
