"""Weight carry-over into the port (counterpart of
``tpu_unet/utils/torch_import.py``), from numpy arrays: the port never imports
JAX, so callers hand it ``jax.device_get``-ed trees or ``.npz``/``.pth`` data.

- :func:`state_dict_from_jax`: the JAX package's (params, batch_stats) trees
  -> the port's ``state_dict`` (reference names, PyTorch layouts), so that the
  port's model computes the JAX model's function. It is the port's own copy of
  ``export_state_dict``'s mapping with one difference: flax's ConvTranspose
  is PyTorch's ``conv_transpose2d`` with the kernel flipped in both spatial
  axes, so the k2s2 kernels are flipped here. ``export_state_dict`` does not
  flip them, so a ``.pth`` it writes runs, in PyTorch and in this port, a
  model whose transposed convs differ from the JAX model's.
- :func:`jax_trees_from_state_dict`: its inverse, for a state_dict or for
  the parameters' gradients, leaf by leaf.
- :func:`qparams_from_numpy` / :func:`qparams_to_numpy`: a JAX int8 qparams
  tree (HWIO int8 kernels) <-> the port's tensors in K2's weight layout.
- :func:`load_reference_checkpoint`: a reference-layout ``.pth``
  (``{"model_state_dict": ...}`` or a bare state_dict).

Layouts: Conv2d HWIO <-> OIHW; ConvTranspose (kh, kw, in, out) <-> (in, out,
kh, kw) with the flip above; BatchNorm scale/bias <-> weight/bias,
batch_stats mean/var <-> running_mean/var. In qparams: 3x3 kernels (3, 3, Cin, Cout) <-> (Cout, 3, 3,
Cin); transposed-conv kernels (2, 2, Cin, Cout) <-> (Cin, 2, 2, Cout), flipped
as above; the 1x1 head matrices (C, K) stay as they are.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np
import torch

_UP_LEAF = re.compile(r"^up(\d+_\d+)?$")  # transposed-conv leaf names


def ladder_layout(model: str = "anomaly_unet") -> List[Tuple[str, str, str]]:
    """``(jax_path, torch_prefix, kind)`` for every layer of a ladder model, in
    forward order. ``kind`` is 'double' (a DoubleConv), 'up' (the k2s2
    transposed conv) or 'head' (a 1x1 OutConv)."""
    if model not in ("unet", "seg_unet", "anomaly_unet"):
        raise ValueError(f"unknown ladder model {model!r}")
    layers = [("encoder/inc", "inc", "double")]
    layers += [(f"encoder/down{i}/conv", f"down{i}.maxpool_conv.1", "double")
               for i in range(1, 5)]
    rows = ((("decoder_recon", "up_recon", "_recon", "outc_recon"),
             ("decoder_seg", "up_seg", "_seg", "outc_seg"))
            if model == "anomaly_unet" else (("decoder", "up", "", "outc"),))
    for dec, up, suffix, outc in rows:
        for i in range(1, 5):
            layers.append((f"{dec}/{up}{i}/up", f"up{i}{suffix}.up", "up"))
            layers.append((f"{dec}/{up}{i}/conv", f"up{i}{suffix}.conv", "double"))
        layers.append((f"{outc}/conv", f"{outc}.conv", "head"))
    return layers


def _get(tree, path: str):
    for part in path.split("/"):
        tree = tree[part]
    return tree


def _f32(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, np.float32))


def state_dict_from_jax(params, batch_stats, model: str = "anomaly_unet",
                        bilinear: bool = False) -> Dict[str, torch.Tensor]:
    """JAX (params, batch_stats) trees (numpy leaves) -> the port's state_dict."""
    if bilinear:
        raise NotImplementedError("bilinear decoders are not ported yet")
    sd: Dict[str, torch.Tensor] = {}

    def conv(leaf, prefix, axes):
        sd[f"{prefix}.weight"] = _f32(np.transpose(np.asarray(leaf["kernel"]), axes))
        if "bias" in leaf:
            sd[f"{prefix}.bias"] = _f32(leaf["bias"])

    for path, prefix, kind in ladder_layout(model):
        p = _get(params, path)
        if kind == "double":
            s = _get(batch_stats, path)
            for i, (ci, bi) in enumerate(((0, 1), (3, 4)), start=1):
                conv(p[f"conv{i}"], f"{prefix}.double_conv.{ci}", (3, 2, 0, 1))
                bn, st = p[f"bn{i}"], s[f"bn{i}"]
                bp = f"{prefix}.double_conv.{bi}"
                sd[f"{bp}.weight"] = _f32(bn["scale"])
                sd[f"{bp}.bias"] = _f32(bn["bias"])
                sd[f"{bp}.running_mean"] = _f32(st["mean"])
                sd[f"{bp}.running_var"] = _f32(st["var"])
                sd[f"{bp}.num_batches_tracked"] = torch.tensor(0, dtype=torch.int64)
        elif kind == "up":  # flax ConvTranspose == torch's with a flipped kernel
            conv({**p, "kernel": np.asarray(p["kernel"])[::-1, ::-1]}, prefix, (2, 3, 0, 1))
        else:
            conv(p, prefix, (3, 2, 0, 1))
    return sd


def jax_trees_from_state_dict(tensors: Dict[str, torch.Tensor],
                              model: str = "anomaly_unet") -> Tuple[Dict, Dict]:
    """Inverse of :func:`state_dict_from_jax`: the port's tensors -> the JAX
    ``(params, batch_stats)`` trees with numpy float32 leaves, transposed-conv
    kernels flipped back. ``tensors`` is a state_dict, or any map from the
    same names to tensors of the same shapes (the parameters' gradients, for
    instance); ``batch_stats`` is filled where the running statistics are
    present."""
    params: Dict = {}
    stats: Dict = {}

    def put(tree, path, leaf):
        node = tree
        for part in path.split("/"):
            node = node.setdefault(part, {})
        node.update(leaf)

    def arr(name):
        return tensors[name].detach().cpu().to(torch.float32).numpy()

    def conv(prefix, axes, flip=False):
        k = np.transpose(arr(f"{prefix}.weight"), axes)
        leaf = {"kernel": np.ascontiguousarray(k[::-1, ::-1] if flip else k)}
        if f"{prefix}.bias" in tensors:
            leaf["bias"] = arr(f"{prefix}.bias")
        return leaf

    for path, prefix, kind in ladder_layout(model):
        if kind == "double":
            for i, (ci, bi) in enumerate(((0, 1), (3, 4)), start=1):
                bp = f"{prefix}.double_conv.{bi}"
                put(params, f"{path}/conv{i}",
                    conv(f"{prefix}.double_conv.{ci}", (2, 3, 1, 0)))
                put(params, f"{path}/bn{i}", {"scale": arr(f"{bp}.weight"),
                                              "bias": arr(f"{bp}.bias")})
                if f"{bp}.running_mean" in tensors:
                    put(stats, f"{path}/bn{i}", {"mean": arr(f"{bp}.running_mean"),
                                                 "var": arr(f"{bp}.running_var")})
        elif kind == "up":  # flax ConvTranspose == torch's with a flipped kernel
            put(params, path, conv(prefix, (2, 3, 0, 1), flip=True))
        else:
            put(params, path, conv(prefix, (2, 3, 1, 0)))
    return params, stats


def _map_layers(node, fn):
    out = {}
    for name, child in node.items():
        if isinstance(child, dict) and "kernel" in child:
            out[name] = fn(name, child)
        elif isinstance(child, dict):
            out[name] = _map_layers(child, fn)
        else:
            out[name] = child
    return out


def _kernel_to_port(name: str, k: np.ndarray) -> np.ndarray:
    if k.ndim == 2:
        return k  # head matrix (C, K)
    if _UP_LEAF.match(name):  # (2, 2, Cin, Cout) -> flipped (Cin, 2, 2, Cout)
        return np.transpose(k[::-1, ::-1], (2, 0, 1, 3))
    return np.transpose(k, (3, 0, 1, 2))  # HWIO -> OHWI


def _kernel_to_jax(name: str, k: np.ndarray) -> np.ndarray:
    if k.ndim == 2:
        return k
    if _UP_LEAF.match(name):
        return np.transpose(k, (1, 2, 0, 3))[::-1, ::-1]
    return np.transpose(k, (1, 2, 3, 0))


def qparams_from_numpy(tree) -> Dict:
    """A JAX qparams tree (numpy-convertible leaves) -> the port's qparams:
    ``{"layers": {... {"kernel", "w_scale", "bias"}}, "scales": {tag: 0-dim
    float32 tensor}}`` on the CPU, kernels in K2's layout."""
    def leaf(name, child):
        k = _kernel_to_port(name, np.asarray(child["kernel"]))
        return {"kernel": torch.from_numpy(np.array(k, np.int8, order="C")),
                "w_scale": _f32(child["w_scale"]), "bias": _f32(child["bias"])}

    return {"layers": _map_layers(tree["layers"], leaf),
            "scales": {tag: _f32(v).reshape(()) for tag, v in tree["scales"].items()}}


def qparams_to_numpy(qparams) -> Dict:
    """Inverse of :func:`qparams_from_numpy`: the JAX layout, numpy leaves."""
    def leaf(name, child):
        k = _kernel_to_jax(name, child["kernel"].cpu().numpy())
        return {"kernel": np.ascontiguousarray(k),
                "w_scale": child["w_scale"].cpu().numpy(),
                "bias": child["bias"].cpu().numpy()}

    return {"layers": _map_layers(qparams["layers"], leaf),
            "scales": {tag: np.float32(v.item()) for tag, v in qparams["scales"].items()}}


def load_reference_checkpoint(path: str) -> Dict[str, torch.Tensor]:
    """The state_dict of a reference-layout ``.pth`` (a training checkpoint
    ``{"model_state_dict": ...}`` or a bare state_dict), on the CPU."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    if isinstance(blob, dict) and "model_state_dict" in blob:
        return blob["model_state_dict"]
    return blob
