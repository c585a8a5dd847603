"""Exported serving artifacts (counterpart of ``tpu_unet/serve_artifact.py``):
deployment without the model code or the checkpoint.

:func:`export_artifact` writes a serving engine's functions as
``torch.export`` programs, and :func:`load_artifact` turns the directory back
into a working :class:`~tpu_unet_torch.serve.AnomalyScorer` or
:class:`~tpu_unet_torch.serve.SegmentationPredictor` that imports no model
code and reads no checkpoint. The kernels are the exception: K1, K2, the
int8 up block's concat and the BN-folded bf16 conv's epilogue are the
operators ``tpu_unet_torch::normalize_u8``, ``tpu_unet_torch::conv3x3_int8``,
``tpu_unet_torch::up_concat_int8`` and ``tpu_unet_torch::bias_relu_bf16``,
which this module's imports register, and a loaded program launches them
(or, on the CPU, their plain versions). A bf16 program exported on the
card records the epilogue operator; one exported on the CPU, or before the
operator existed, holds the composed ops. An int8 program exported before the
concat operator existed holds the composed ops instead and loads as it did.

Layout:

- ``meta.json``: the JAX package's keys (``format_version``, ``kind``,
  ``batch_size``, ``image_size_hw``, ``num_classes``, ``quantize``,
  ``with_heatmap``, ``bucket_sizes``, ``platforms``: the device types that
  have programs), plus the ``device`` type the engine ran on at export and
  ``torch_version``;
- ``weights.pt``: the tensors the engine's forward reads, stored once: the
  BN-folded parameters, or the int8 executor's prepared constants (K2's
  packed kernels, combined scales, biases) with the activation scales and
  the attention gates' float leaves;
- ``program_b<N>.pt2`` (and ``heatmap_b<N>.pt2`` for an anomaly engine built
  ``with_heatmap``): one program per batch size of the engine's bucket
  ladder, or one at ``batch_size`` without a ladder, for the engine's
  device; ``program_<platform>_b<N>.pt2`` (and ``heatmap_...``) for each
  other platform. Each takes ``(weights, images_u8)``; none holds the
  weights, so a ladder and a platform cost one copy of them. Static shapes
  per bucket keep each program the graph the live engine runs, and the
  loaded engine sends each padded batch to its size's program.

A program records the device it was traced on, so one is written for each
platform, as the JAX package lowers one module per platform:
``export_artifact(..., platforms=["cuda", "cpu"])``. The engine's own
program is traced; another platform's is the same graph moved by
``torch.export.passes.move_to_device_pass`` (which needs a GPU when it moves
to ``cuda``). The weights are the engine's, the int8 constants those of its
own calibration, and the kernels, operators that dispatch by device, run their
plain versions in a CPU program (they are exact: the CPU program of an int8
engine gives the CUDA program's activations). ``load_artifact`` runs the
programs of its device's type and raises, naming the artifact's platforms,
when there are none. Artifacts written before the platforms' programs
existed (one device, ``platforms`` that device) load as they did. An engine
with replicas on several devices is refused: export one built on one device
and serve one artifact per device.
"""

from __future__ import annotations

import json
import os
from typing import List, Optional, Sequence, Union

import torch
from torch.export.passes import move_to_device_pass

from tpu_unet_torch.core.device import resolve_device
from tpu_unet_torch.ops.kernels import int8_conv, preprocess, up_concat  # noqa: F401 — ops
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


def _program_name(stem: str, batch: int, platform: Optional[str] = None) -> str:
    """A program's file: ``platform`` None for the engine's own device."""
    return f"{stem}_b{batch}.pt2" if platform is None else f"{stem}_{platform}_b{batch}.pt2"


# Platform names the port exports for ('gpu' is the JAX package's name).
_PLATFORMS = {"cuda": "cuda", "gpu": "cuda", "cpu": "cpu"}


def artifact_platforms(platforms: Optional[Sequence[str]], device_type: str) -> List[str]:
    """The device types of ``platforms`` (``cuda``, ``gpu`` as ``cuda``,
    ``cpu``; duplicates dropped), or ``[device_type]`` for None. ValueError
    for ``tpu``, which the port cannot serve, and for any other name."""
    if platforms is None:
        return [device_type]
    out: List[str] = []
    for p in platforms:
        key = str(p).strip().lower()
        if key == "tpu":
            raise ValueError(
                "artifact platforms: 'tpu' is refused: the port's programs are torch.export "
                "graphs of PyTorch operators and of its CUDA kernels, which run on cuda and "
                "cpu devices; a TPU artifact is exported by the JAX package")
        if key not in _PLATFORMS:
            raise ValueError(f"artifact platforms: unknown platform {p!r}; the port "
                             f"exports {sorted(_PLATFORMS)}")
        if _PLATFORMS[key] not in out:
            out.append(_PLATFORMS[key])
    if not out:
        raise ValueError("artifact platforms: none named")
    return out


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
    dict. ``platforms`` (:func:`artifact_platforms`; default the engine's
    device type) are the device types to write programs for."""
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
    plats = artifact_platforms(platforms, device.type)
    if device.type != "cuda" and "cuda" in plats and not torch.cuda.is_available():
        raise ValueError(f"artifact platforms {plats}: a cuda program is moved from the "
                         f"traced one on a machine with a GPU, and this one has none")
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
            if device.type in plats:
                torch.export.save(program, os.path.join(out_dir, _program_name(stem, int(b))))
            for plat in plats:
                if plat != device.type:
                    torch.export.save(move_to_device_pass(program, plat), os.path.join(
                        out_dir, _program_name(stem, int(b), plat)))

    meta = {"format_version": _FORMAT_VERSION, "kind": kind,
            "batch_size": engine.batch_size, "image_size_hw": [int(h), int(w)],
            "device": device.type, "platforms": plats,
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
    (``cuda`` unless the caller asks for ``cpu``), whose type must be one of
    the artifact's ``platforms``."""
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
    plats = meta.get("platforms") or [meta["device"]]
    kind_of = torch.device(device).type
    if kind_of not in plats:
        raise ValueError(f"artifact {artifact_dir!r} was exported on {meta['device']} with "
                         f"programs for the platforms {plats}; it has none for {device}")
    platform = None if kind_of == meta["device"] else kind_of
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
        calls = {int(b): torch.export.load(
            path_of(_program_name(stem, int(b), platform))).module() for b in buckets}
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
