"""Model export: ``torch.export`` of the inference forward (counterpart of
``u2seg_tpu/engine/export.py``, which serializes a jitted forward as a
StableHLO artifact).

``TracingAdapter`` wraps a model whose outputs are ``PanopticOutput`` /
``Detections`` dataclasses into a module that returns a flat tuple of
tensors; both dataclasses are registered with ``torch.utils._pytree``, so
``unflatten`` rebuilds them. ``export_inference`` exports the adapter at one
input shape and writes the program with its weights; ``load_exported`` loads
it back as a callable.

What the graph holds of the port: the hand-written multilevel ROIAlign is
the registered op ``u2seg_torch::multilevel_roi_align`` (its CUDA
implementation launches the kernel, its CPU implementation is the plain
twin), and the two host-synced fixpoints (NMS self-suppression, the fusion's
greedy pass) are the ops ``u2seg_torch::nms_self_suppression`` and
``u2seg_torch::panoptic_greedy_take``. The artifact therefore needs those
ops registered where it is loaded: ``load_exported`` imports the modules that
register them (``import u2seg_torch`` plus those modules), where the JAX
package's StableHLO artifact needs no package at all. It needs no model code:
the weights are inside.
"""
from __future__ import annotations

import json
import logging
import os
from typing import Any, Optional, Sequence, Tuple, Union

import torch
import torch.utils._pytree as pytree

logger = logging.getLogger(__name__)

PROGRAM = "model.pt2"
SCHEMA = "schema.json"


def register_output_types() -> None:
    """Register ``Detections`` and ``PanopticOutput`` as pytree nodes (once)."""
    from u2seg_torch.models.panoptic_fpn import PanopticOutput
    from u2seg_torch.structures.instances import Detections

    for cls in (Detections, PanopticOutput):
        if cls not in pytree.SUPPORTED_NODES:
            pytree.register_dataclass(
                cls, serialized_type_name=f"{cls.__module__}.{cls.__qualname__}")


class TracingAdapter(torch.nn.Module):
    """``model(images, sizes, combine=...)`` -> a flat tuple of tensors (ref
    export/flatten.py:186). ``outputs_schema`` (the tree spec of the last
    call) rebuilds the structured output with ``unflatten``."""

    def __init__(self, model: torch.nn.Module, combine: bool = True):
        super().__init__()
        register_output_types()
        self.model = model
        self.combine = combine
        self.outputs_schema = None

    def forward(self, images: torch.Tensor, sizes: torch.Tensor):
        out = self.model(images, sizes, combine=self.combine)
        flat, spec = pytree.tree_flatten(out)
        self.outputs_schema = spec
        return tuple(flat)

    def trace_schema(self, images: torch.Tensor, sizes: torch.Tensor):
        """Set ``outputs_schema`` from a fake-tensor run of the forward (no
        computation; ``torch.export`` undoes what its own trace sets on the
        module)."""
        from torch._subclasses.fake_tensor import FakeTensorMode

        with torch.no_grad(), FakeTensorMode(allow_non_fake_inputs=True) as mode:
            self(mode.from_tensor(images), mode.from_tensor(sizes))
        return self.outputs_schema

    def unflatten(self, flat: Sequence[Any]):
        assert self.outputs_schema is not None, "call the adapter first"
        return pytree.tree_unflatten(list(flat), self.outputs_schema)


def output_names(spec: pytree.TreeSpec):
    """The key path of every flat output of a tree spec (``detections.boxes``,
    ``panoptic``, ...), in flat order."""
    leaves, _ = pytree.tree_flatten_with_path(
        pytree.tree_unflatten(list(range(spec.num_leaves)), spec))
    return [".".join(k.name for k in path) for path, _ in leaves]


def export_inference(
    model: torch.nn.Module,
    input_shape: Tuple[int, int, int, int],
    path: str,
    combine: bool = True,
    device: Optional[Union[str, torch.device]] = None,
) -> torch.export.ExportedProgram:
    """Export the inference forward at ``input_shape`` (B, H, W, 3) and write

      model.pt2   -- ``torch.export.save`` of the program, weights inside;
      schema.json -- the flat outputs' names, shapes and dtypes, the input
                     shape, and the output tree spec.

    The model runs on ``device`` (``cuda`` unless the caller names one; with
    no GPU and no device this raises). Returns the exported program."""
    from u2seg_torch.models.build import resolve_device

    dev = resolve_device(device)
    model = model.to(dev).eval()
    b, h, w, c = input_shape
    images = torch.zeros((b, h, w, c), dtype=torch.float32, device=dev)
    sizes = torch.tensor([[h, w]] * b, dtype=torch.int32, device=dev)
    adapter = TracingAdapter(model, combine).eval()
    names = output_names(adapter.trace_schema(images, sizes))
    with torch.no_grad():
        program = torch.export.export(adapter, (images, sizes), strict=False)
    os.makedirs(path, exist_ok=True)
    torch.export.save(program, os.path.join(path, PROGRAM))
    outs = [n for n in program.graph.nodes if n.op == "output"][0].args[0]
    schema = {
        "input_shape": [b, h, w, c], "combine": combine, "device": str(dev),
        "outputs": [{"name": name, "shape": list(node.meta["val"].shape),
                     "dtype": str(node.meta["val"].dtype).replace("torch.", "")}
                    for name, node in zip(names, outs)],
        "treespec": pytree.treespec_dumps(adapter.outputs_schema),
    }
    with open(os.path.join(path, SCHEMA), "w") as f:
        json.dump(schema, f, indent=1)
    logger.info("Exported the inference forward to %s", path)
    return program


def load_schema(path: str) -> dict:
    with open(os.path.join(path, SCHEMA)) as f:
        return json.load(f)


def load_exported(path: str):
    """Load an artifact of ``export_inference``; returns a callable
    ``(images, sizes) -> flat output tuple``, in the order of
    ``schema.json``'s outputs, on the device the program was exported on.

    The program calls the port's registered ops, so this imports the modules
    that register them (the package ``u2seg_torch`` must be importable; the
    JAX package's StableHLO artifact needs no package). It builds no model:
    the weights are in the artifact."""
    from u2seg_torch.ops import fusion, nms, roi_align_ml  # noqa: F401  (register the ops)

    program = torch.export.load(os.path.join(path, PROGRAM))
    module = program.module()

    def call(images: torch.Tensor, sizes: torch.Tensor):
        with torch.no_grad():
            return tuple(module(images, sizes))

    call.program = program
    return call


def unflatten_outputs(flat: Sequence[torch.Tensor], path: str):
    """Rebuild the ``PanopticOutput`` of a loaded program's flat outputs
    from the artifact's saved tree spec."""
    register_output_types()
    spec = pytree.treespec_loads(load_schema(path)["treespec"])
    return pytree.tree_unflatten(list(flat), spec)
