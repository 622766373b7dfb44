"""u2seg_torch stands alone: it imports neither JAX, the JAX package nor
OpenCV (the machine with the card has none of them), Pillow only inside the
calls of ``data/image_io.py``, and its entry points refuse to fall back to
the CPU silently.

"Names" below means imports: every ``import`` / ``from ... import`` and every
``importlib.import_module`` / ``__import__`` call with a literal module name,
found by parsing the sources. (Docstrings may cite the JAX package's files:
the kernel's note names the TPU kernel it replaces.)
"""
import ast
import os
import subprocess
import sys

import pytest
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "u2seg_tpu", "cv2")


def _port_sources():
    pkg = os.path.join(ROOT, "u2seg_torch")
    out = [os.path.join(ROOT, "chip_smoke.py")]
    for d, _, files in os.walk(pkg):
        out += [os.path.join(d, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _imported_names(path):
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module
        elif isinstance(node, ast.Call) and node.args and isinstance(
                node.args[0], ast.Constant) and isinstance(node.args[0].value, str):
            fn = node.func
            name = fn.attr if isinstance(fn, ast.Attribute) else getattr(fn, "id", "")
            if name in ("import_module", "__import__"):
                yield node.args[0].value


def test_no_source_imports_jax_or_the_jax_package():
    files = _port_sources()
    assert len(files) > 15 and os.path.join(ROOT, "chip_smoke.py") in files
    rel = {os.path.relpath(p, os.path.join(ROOT, "u2seg_torch")) for p in files}
    assert {"engine/predictor.py", "engine/device_render.py",
            "engine/panoptic_render.py", "data/transforms.py",
            "evaluation/rle.py", "ops/roi_align_single.py",
            "dev/profile_window_read.py", "engine/events.py", "engine/hooks.py",
            "engine/checkpoint.py", "engine/train_loop.py", "engine/precise_bn.py",
            "parallel/comm.py", "parallel/launch.py", "parallel/mesh.py",
            "data/catalog.py", "data/builtin_meta.py", "data/image_io.py",
            "data/coco.py", "data/builtin.py", "data/loader.py",
            "evaluation/coco_api.py", "evaluation/evaluator.py",
            "evaluation/hungarian.py", "evaluation/coco_eval_core.py",
            "evaluation/coco_evaluator.py", "evaluation/sem_seg_evaluator.py",
            "evaluation/panoptic_eval_core.py", "evaluation/panoptic_evaluator.py",
            "evaluation/testing.py", "structures/masks.py", "data/mapper.py",
            "tools/train_net.py", "tools/plain_train_net.py", "tools/benchmark.py",
            "tools/convert_weights.py", "pseudo/dino.py", "pseudo/kmeans.py",
            "pseudo/uslt.py", "pseudo/assembly.py", "tools/generate_pseudo_labels.py",
            "models/rcnn.py", "models/dense_detector.py", "models/keypoint_head.py",
            "structures/keypoints.py", "models/tta.py", "model_zoo.py",
            "models/regnet.py", "models/vit.py", "models/swin.py", "models/mvit.py",
            "data/pascal_voc.py", "data/lvis.py", "data/cityscapes.py",
            "evaluation/pascal_voc_evaluator.py", "evaluation/lvis_evaluator.py",
            "evaluation/cityscapes_instance_ap.py",
            "evaluation/cityscapes_evaluator.py", "data/warp.py",
            "pseudo/semisup.py", "structures/rotated_boxes.py",
            "evaluation/rotated_coco_evaluator.py", "ops/deform_conv.py", "ops/aspp.py",
            "projects/__init__.py", "projects/deeplab.py", "projects/panoptic_deeplab.py",
            "projects/rethinking_bn.py", "utils/registry.py", "utils/serialize.py",
            "utils/file_io.py", "utils/logger.py", "utils/env.py", "utils/memory.py",
            "utils/tracing.py", "utils/tracking.py", "utils/visualizer.py", "utils/raster.py",
            "utils/analysis.py", "engine/export.py", "lazy.py", "demo/predictor.py",
            "demo/u2seg_demo.py", "tools/analyze_model.py", "tools/visualize_data.py",
            "tools/visualize_json_results.py", "tools/lazyconfig_train_net.py",
            "ops/fusion.py", "projects/pointrend.py", "projects/pointsup.py",
            "projects/tridentnet.py", "projects/tensormask.py", "projects/densepose.py",
            "projects/densepose_cse.py", "projects/densepose_data.py",
            "projects/densepose_eval.py", "tools/prepare_ade20k_sem_seg.py",
            "_native/__init__.py", "dev/run_overfit.py"} <= rel
    bad = [(os.path.relpath(p, ROOT), n) for p in files for n in _imported_names(p)
           if n.split(".")[0] in FORBIDDEN]
    assert not bad, bad


def test_opencv_is_named_only_as_the_demos_optional_video_decoder():
    """No source imports OpenCV (the check above). The demo's ``--video-input``
    and ``--webcam`` look it up by name when they are used, and raise where it
    is missing: that one constant is the only place the port names it."""
    named = []
    for p in _port_sources():
        with open(p) as f:
            tree = ast.parse(f.read(), p)
        named += [(os.path.relpath(p, ROOT), node.lineno) for node in ast.walk(tree)
                  if isinstance(node, ast.Constant) and node.value == "cv2"]
    assert [n for n, _ in named] == ["u2seg_torch/demo/u2seg_demo.py"], named
    from u2seg_torch.demo import u2seg_demo

    assert u2seg_demo.VIDEO_MODULE == "cv2"


def _module_level_imports(path):
    """Imports that run when the module is imported: those outside any
    function or class body."""
    with open(path) as f:
        tree = ast.parse(f.read(), path)
    stack = [(n, False) for n in tree.body]
    while stack:
        node, nested = stack.pop()
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            continue
        if isinstance(node, ast.Import) and not nested:
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and not nested:
            yield node.module
        stack += [(c, nested or isinstance(node, ast.ClassDef))
                  for c in ast.iter_child_nodes(node)]


def test_pil_is_imported_only_inside_the_jpeg_path():
    """Every image file is read and written through ``data/image_io.py``,
    which imports PIL inside one helper that its calls share, so importing
    the port needs no Pillow."""
    files = _port_sources()
    at_import = [(os.path.relpath(p, ROOT), n) for p in files
                 for n in _module_level_imports(p) if n.split(".")[0] == "PIL"]
    assert not at_import, at_import
    anywhere = sorted({os.path.relpath(p, ROOT) for p in files
                       if any(n.split(".")[0] == "PIL" for n in _imported_names(p))})
    assert anywhere == ["u2seg_torch/data/image_io.py"]
    with open(os.path.join(ROOT, "u2seg_torch", "data", "image_io.py")) as f:
        tree = ast.parse(f.read())
    owners = [fn.name for fn in ast.walk(tree) if isinstance(fn, ast.FunctionDef)
              and any(isinstance(n, ast.ImportFrom) and n.module == "PIL"
                      for n in ast.walk(fn))]
    assert owners == ["_pil"]


def test_importing_the_port_loads_no_jax():
    code = (
        "import pkgutil, sys, importlib\n"
        "import u2seg_torch, u2seg_torch.entry\n"
        "for m in pkgutil.walk_packages(u2seg_torch.__path__, 'u2seg_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "bad = [k for k in sys.modules if k.split('.')[0] in %r]\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n" % (FORBIDDEN + ("PIL",),)
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_entry_points_refuse_to_fall_back_to_cpu(monkeypatch):
    from u2seg_torch.config import Config
    from u2seg_torch.engine.predictor import DefaultPredictor, run_panoptic_evaluation
    from u2seg_torch.engine.train_loop import DefaultTrainer
    from u2seg_torch.engine.trainer import create_train_state
    from u2seg_torch.entry import entry
    from u2seg_torch.models.build import build_model
    from u2seg_torch.parallel.mesh import create_mesh

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        build_model(Config())
    from u2seg_torch import model_zoo

    for rel in model_zoo.list_configs():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            build_model(model_zoo.get_config(rel))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model_zoo.get("COCO-Keypoints/keypoint_rcnn_R_50_FPN_1x.yaml")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_train_state(Config())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DefaultPredictor(Config())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        create_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        DefaultTrainer(Config(), [])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_panoptic_evaluation(Config())
    from u2seg_torch.tools import train_net

    for extra in ([], ["--eval-only"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            train_net.main(extra)
    from u2seg_torch.tools import generate_pseudo_labels

    for extra in ([], ["--stage", "supergt"], ["--device", "cuda:0"]):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            generate_pseudo_labels.main(extra)


def test_pseudo_label_tool_runs_on_the_cpu_when_asked(tmp_path, monkeypatch):
    """``--device cpu`` is the one way past the check: a stage that needs no
    device then runs with no GPU."""
    import json

    from u2seg_torch.tools import generate_pseudo_labels

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    gt = tmp_path / "gt.json"
    gt.write_text(json.dumps({"annotations": [], "categories": []}))
    out = tmp_path / "super.json"
    res = generate_pseudo_labels.main(["--stage", "supergt", "--device", "cpu",
                                       "--gt-panoptic-json", str(gt), "--super-json", str(out)])
    assert list(res) == ["supergt"] and res["supergt"]["annotations"] == 0 and out.exists()


def test_this_slices_entry_points_refuse_to_fall_back_to_cpu(monkeypatch, tmp_path):
    from u2seg_torch import config as tconfig
    from u2seg_torch.demo import predictor as demo_predictor
    from u2seg_torch.demo import u2seg_demo
    from u2seg_torch.engine.export import export_inference
    from u2seg_torch.tools import analyze_model, lazyconfig_train_net

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo_predictor.VisualizationDemo(tconfig.Config())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo_predictor.AsyncPredictor(tconfig.Config())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        u2seg_demo.main(["--config-file", "", "--input", str(tmp_path / "x.png")])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        analyze_model.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        export_inference(torch.nn.Identity(), (1, 64, 64, 3), str(tmp_path / "e"))
    cfg = tmp_path / "lazy.py"
    cfg.write_text(f"train = dict(max_iter=1, output_dir={str(tmp_path / 'o')!r})\n")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        lazyconfig_train_net.main(["--config-file", str(cfg)])
