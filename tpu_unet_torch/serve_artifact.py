"""Exported serving artifacts (counterpart of ``tpu_unet/serve_artifact.py``):
deployment without the model code or the checkpoint.

:func:`export_artifact` writes a serving engine's functions as
``torch.export`` programs, and :func:`load_artifact` turns the directory back
into a working :class:`~tpu_unet_torch.serve.AnomalyScorer` or
:class:`~tpu_unet_torch.serve.SegmentationPredictor` that imports no model
code and reads no checkpoint. The kernels are the exception: K1 and K2 are
the operators ``tpu_unet_torch::normalize_u8`` and
``tpu_unet_torch::conv3x3_int8``, which this module's imports register, and
a loaded program launches them (or, on the CPU, their plain versions).

Layout:

- ``meta.json``: the JAX package's keys (``format_version``, ``kind``,
  ``batch_size``, ``image_size_hw``, ``num_classes``, ``quantize``,
  ``with_heatmap``, ``bucket_sizes``), plus the ``device`` type the programs
  were exported on and ``torch_version``;
- ``weights.pt``: the tensors the engine's forward reads, stored once: the
  BN-folded parameters, or the int8 executor's prepared constants (K2's
  packed kernels, combined scales, biases) with the activation scales and
  the attention gates' float leaves;
- ``program_b<N>.pt2`` (and ``heatmap_b<N>.pt2`` for an anomaly engine built
  ``with_heatmap``): one program per batch size of the engine's bucket
  ladder, or one at ``batch_size`` without a ladder. Each takes
  ``(weights, images_u8)``; none holds the weights, so a ladder costs one
  copy of them. Static shapes per bucket keep each program the graph the
  live engine runs, and the loaded engine sends each padded batch to its
  size's program.

A program records the device it was traced on: an artifact loads on that
device type only (``load_artifact`` raises otherwise; it never moves a CUDA
artifact to the CPU). The JAX package can export one module for several
platforms; this format cannot. The port's engines serve one device, so there
is no sharded engine to reject.
"""

from __future__ import annotations

import json
import os
from typing import Optional, Sequence, Union

import torch

from tpu_unet_torch.core.device import resolve_device
from tpu_unet_torch.ops.kernels import int8_conv, preprocess  # noqa: F401 — registers K1 and K2
from tpu_unet_torch.serve import AnomalyScorer, SegmentationPredictor

_META_NAME = "meta.json"
_WEIGHTS_NAME = "weights.pt"
_FORMAT_VERSION = 1


class _Program(torch.nn.Module):
    """An engine's serving function ``fn(images_u8)`` run on ``params``
    passed as the program's first input (``bind(params)`` puts them in place
    of the live tensors while ``fn`` runs)."""

    def __init__(self, fn, bind):
        super().__init__()
        self._fn, self._bind = fn, bind

    def forward(self, params, images_u8):
        with self._bind(params):
            return self._fn(images_u8)


def _clone_tree(tree):
    """Copies of a nested dict's tensors made outside inference mode (the
    executor's constants are made inside it, and tracing wants plain ones)."""
    if isinstance(tree, dict):
        return {k: _clone_tree(v) for k, v in tree.items()}
    return tree.clone()


def _program_name(stem: str, batch: int) -> str:
    return f"{stem}_b{batch}.pt2"


def _engine_functions(engine):
    if isinstance(engine, AnomalyScorer):
        fns = {"program": engine._score_fn, "heatmap": engine._heatmap_fn}
        return "anomaly_scorer", (engine.image_size, engine.image_size), fns
    if isinstance(engine, SegmentationPredictor):
        return "segmentation_predictor", engine.image_size_hw, {"program": engine._predict_fn}
    raise TypeError(f"unsupported engine type {type(engine).__name__}")


def export_artifact(engine: Union[AnomalyScorer, SegmentationPredictor], out_dir: str,
                    platforms: Optional[Sequence[str]] = None) -> dict:
    """Write ``engine``'s serving functions to ``out_dir``; returns the meta
    dict. ``platforms`` may only name the engine's device type (the JAX
    package's multi-platform export has no counterpart here)."""
    if len(engine.devices) > 1:
        raise ValueError(
            "artifacts are per-device programs; export an engine built without "
            "n_devices and serve one artifact per device")
    kind, (h, w), fns = _engine_functions(engine)
    fns = {stem: fn for stem, fn in fns.items() if fn is not None}
    if engine._export_state is None:
        raise ValueError("this engine was loaded from an artifact; export the engine "
                         "built from the checkpoint instead")
    device = engine.device
    if platforms is not None and {("cuda" if p == "gpu" else p) for p in platforms} != {device.type}:
        raise ValueError(f"artifact platforms {list(platforms)}: a torch.export program "
                         f"serves the device it was exported on ({device.type}) only")
    buckets = engine.bucket_sizes or (engine.batch_size,)
    # One call of each function prepares every layer its program runs (the
    # int8 executor makes each layer's constants on its first call).
    with engine._serving():
        for fn in fns.values():
            fn(torch.zeros((buckets[0], h, w, 3), dtype=torch.uint8, device=device))
    params_fn, bind = engine._export_state
    params = _clone_tree(params_fn())
    os.makedirs(out_dir, exist_ok=True)
    torch.save(params, os.path.join(out_dir, _WEIGHTS_NAME))
    for stem, fn in fns.items():
        for b in buckets:
            example = torch.zeros((int(b), h, w, 3), dtype=torch.uint8, device=device)
            program = torch.export.export(_Program(fn, bind), (params, example), strict=False)
            program.example_inputs = None  # else each program keeps a copy of the weights
            torch.export.save(program, os.path.join(out_dir, _program_name(stem, int(b))))

    meta = {"format_version": _FORMAT_VERSION, "kind": kind,
            "batch_size": engine.batch_size, "image_size_hw": [int(h), int(w)],
            "device": device.type, "platforms": [device.type],
            "torch_version": torch.__version__}
    if getattr(engine, "num_classes", None) is not None:
        meta["num_classes"] = int(engine.num_classes)
    if engine.quantize:
        meta["quantize"] = engine.quantize
    if "heatmap" in fns:
        meta["with_heatmap"] = True
    if engine.bucket_sizes:
        meta["bucket_sizes"] = [int(b) for b in engine.bucket_sizes]
    with open(os.path.join(out_dir, _META_NAME), "w") as f:
        json.dump(meta, f, indent=2)
    return meta


def _shape_dispatch(calls: dict, weights, what: str):
    """``fn(images_u8)`` that runs the program of the batch's size."""
    def fn(images_u8):
        call = calls.get(int(images_u8.shape[0]))
        if call is None:
            raise ValueError(f"this artifact's {what} programs take batch sizes "
                             f"{sorted(calls)}; got a batch of {int(images_u8.shape[0])}")
        return call(weights, images_u8)

    return fn


def load_artifact(artifact_dir: str, device="cuda") -> Union[AnomalyScorer,
                                                              SegmentationPredictor]:
    """Rebuild a serving engine from an exported artifact, on ``device``
    (``cuda`` unless the caller asks for ``cpu``), which must be of the
    device type it was exported on."""
    meta_path = os.path.join(artifact_dir, _META_NAME)
    if not os.path.exists(meta_path):
        raise FileNotFoundError(f"not a serving artifact (no {_META_NAME}): "
                                f"{artifact_dir!r}")
    with open(meta_path) as f:
        meta = json.load(f)
    if meta.get("format_version") != _FORMAT_VERSION or "device" not in meta:
        raise ValueError(f"unsupported artifact format_version "
                         f"{meta.get('format_version')!r} in {artifact_dir!r} (or an "
                         "artifact of the JAX package, which this package cannot load)")
    if torch.device(device).type != meta["device"]:
        raise ValueError(f"artifact {artifact_dir!r} was exported on {meta['device']} and "
                         f"serves there only, not on {device}")
    device = resolve_device(device)

    def path_of(name: str) -> str:
        path = os.path.join(artifact_dir, name)
        if not os.path.exists(path):
            raise FileNotFoundError(f"corrupt serving artifact (has {_META_NAME} but no "
                                    f"{name}): {artifact_dir!r}")
        return path

    weights = torch.load(path_of(_WEIGHTS_NAME), map_location=device, weights_only=True)
    buckets = meta.get("bucket_sizes") or [meta["batch_size"]]

    def programs(stem: str):
        calls = {int(b): torch.export.load(path_of(_program_name(stem, int(b)))).module()
                 for b in buckets}
        return _shape_dispatch(calls, weights, stem)

    h, w = meta["image_size_hw"]
    common = dict(batch_size=meta["batch_size"], device=device,
                  quantize=meta.get("quantize"), bucket_sizes=meta.get("bucket_sizes"))
    if meta["kind"] == "anomaly_scorer":
        if h != w:
            raise ValueError(f"anomaly_scorer artifacts are square; got {h}x{w}")
        return AnomalyScorer(programs("program"), h,
                             heatmap_fn=programs("heatmap") if meta.get("with_heatmap") else None,
                             **common)
    if meta["kind"] == "segmentation_predictor":
        return SegmentationPredictor(programs("program"), (h, w),
                                     num_classes=meta.get("num_classes"), **common)
    raise ValueError(f"unknown artifact kind {meta['kind']!r}")
