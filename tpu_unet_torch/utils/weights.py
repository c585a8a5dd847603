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
as above; the 1x1 head matrices (C, K) stay as they are; an attention gate's
leaves stay folded float32 convs (HWIO <-> OIHW, no ``w_scale``).

Layer names: :func:`model_layout` lists each model's layers by JAX path and
torch prefix, for the ladders with or without bilinear decoders and
attention gates, and for UNet++'s grid with or without deep supervision.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

import numpy as np
import torch

UP_LEAF = re.compile(r"^up(\d+_\d+)?$")  # transposed-conv leaf names

# np.transpose axes from a PyTorch kernel to its JAX leaf: Conv2d OIHW ->
# HWIO, ConvTranspose2d (in, out, kh, kw) -> (kh, kw, in, out).
CONV_TO_JAX = (2, 3, 1, 0)
CONV_T_TO_JAX = (2, 3, 0, 1)


# (jax conv, jax bn, torch conv, torch bn) of each conv -> BN pair of a
# layer kind, relative to the layer's path and prefix.
CONV_BN = {
    "double": (("conv1", "bn1", "double_conv.0", "double_conv.1"),
               ("conv2", "bn2", "double_conv.3", "double_conv.4")),
    "gate": (("g/conv1", "g/bn1", "g.conv1", "g.bn1"),
             ("x/conv1", "x/bn1", "x.conv1", "x.bn1"),
             ("conv2", "bn2", "conv2", "bn2")),
}


def ladder_layout(model: str = "anomaly_unet",
                  bilinear: bool = False) -> List[Tuple[str, str, str]]:
    """``(jax_path, torch_prefix, kind)`` for every layer of a ladder model
    ('unet', 'seg_unet', 'anomaly_unet', 'attn_unet'), in forward order.
    ``kind`` is 'double' (a DoubleConv), 'gate' (an attention gate), 'up'
    (the k2s2 transposed conv, absent from bilinear decoders) or 'head' (a
    1x1 OutConv)."""
    if model not in ("unet", "seg_unet", "anomaly_unet", "attn_unet"):
        raise ValueError(f"unknown ladder model {model!r}")
    layers = [("encoder/inc", "inc", "double")]
    layers += [(f"encoder/down{i}/conv", f"down{i}.maxpool_conv.1", "double")
               for i in range(1, 5)]
    rows = ((("decoder_recon", "up_recon", "_recon", "outc_recon"),
             ("decoder_seg", "up_seg", "_seg", "outc_seg"))
            if model == "anomaly_unet" else (("decoder", "up", "", "outc"),))
    for dec, up, suffix, outc in rows:
        for i in range(1, 5):
            if model == "attn_unet":
                layers.append((f"{dec}/{up}{i}/att", f"up{i}{suffix}.att", "gate"))
            if not bilinear:
                layers.append((f"{dec}/{up}{i}/up", f"up{i}{suffix}.up", "up"))
            layers.append((f"{dec}/{up}{i}/conv", f"up{i}{suffix}.conv", "double"))
        layers.append((f"{outc}/conv", f"{outc}.conv", "head"))
    return layers


def model_layout(model: str = "anomaly_unet", bilinear: bool = False,
                 deep_supervision: bool = False) -> List[Tuple[str, str, str]]:
    """:func:`ladder_layout`, and for 'unetpp' the nested grid: nodes
    ``x{i}_{j}``, level-up convs ``up{i}_{j}`` (not bilinear) and the head
    ``outc`` or, with deep supervision, ``outc_1``..``outc_4``; JAX paths and
    torch prefixes are the same names."""
    if model != "unetpp":
        return ladder_layout(model, bilinear)
    layers = []
    for j in range(5):
        for i in range(5 - j):
            if j and not bilinear:
                layers.append((f"up{i}_{j}", f"up{i}_{j}", "up"))
            layers.append((f"x{i}_{j}", f"x{i}_{j}", "double"))
    heads = [f"outc_{j}" for j in range(1, 5)] if deep_supervision else ["outc"]
    return layers + [(f"{h}/conv", f"{h}.conv", "head") for h in heads]


def layout_of(model: str, names) -> List[Tuple[str, str, str]]:
    """:func:`model_layout` of the model whose state_dict keys are ``names``:
    bilinear when it has no transposed conv, deep supervision when it has
    ``outc_1``."""
    names = set(names)
    bilinear = not any(n.endswith(".up.weight") or re.fullmatch(r"up\d+_\d+\.weight", n)
                       for n in names)
    return model_layout(model, bilinear, "outc_1.conv.weight" in names)


def _get(tree, path: str):
    for part in path.split("/"):
        tree = tree[part]
    return tree


def _f32(v) -> torch.Tensor:
    return torch.from_numpy(np.array(v, np.float32))


def state_dict_from_jax(params, batch_stats, model: str = "anomaly_unet",
                        bilinear: bool = False,
                        deep_supervision: bool = False) -> Dict[str, torch.Tensor]:
    """JAX (params, batch_stats) trees (numpy leaves) -> the port's state_dict."""
    sd: Dict[str, torch.Tensor] = {}

    def conv(leaf, prefix, axes):
        sd[f"{prefix}.weight"] = _f32(np.transpose(np.asarray(leaf["kernel"]), axes))
        if "bias" in leaf:
            sd[f"{prefix}.bias"] = _f32(leaf["bias"])

    for path, prefix, kind in model_layout(model, bilinear, deep_supervision):
        p = _get(params, path)
        if kind in CONV_BN:
            s = _get(batch_stats, path)
            for jconv, jbn, tconv, tbn in CONV_BN[kind]:
                conv(_get(p, jconv), f"{prefix}.{tconv}", (3, 2, 0, 1))
                bn, st = _get(p, jbn), _get(s, jbn)
                bp = f"{prefix}.{tbn}"
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
    instance); the layout (bilinear, deep supervision) is read from the
    names (:func:`layout_of`), and ``batch_stats`` is filled where the
    running statistics are present."""
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

    for path, prefix, kind in layout_of(model, tensors):
        if kind in CONV_BN:
            for jconv, jbn, tconv, tbn in CONV_BN[kind]:
                bp = f"{prefix}.{tbn}"
                put(params, f"{path}/{jconv}", conv(f"{prefix}.{tconv}", CONV_TO_JAX))
                put(params, f"{path}/{jbn}", {"scale": arr(f"{bp}.weight"),
                                              "bias": arr(f"{bp}.bias")})
                if f"{bp}.running_mean" in tensors:
                    put(stats, f"{path}/{jbn}", {"mean": arr(f"{bp}.running_mean"),
                                                 "var": arr(f"{bp}.running_var")})
        elif kind == "up":  # flax ConvTranspose == torch's with a flipped kernel
            put(params, path, conv(prefix, CONV_T_TO_JAX, flip=True))
        else:
            put(params, path, conv(prefix, CONV_TO_JAX))
    return params, stats


def jax_axes(model: torch.nn.Module) -> Dict[str, Tuple[int, ...]]:
    """For each parameter of ``model``, the axes that carry it into its JAX
    leaf's layout (``np.transpose(p, axes)``): :data:`CONV_TO_JAX` for a
    Conv2d kernel, :data:`CONV_T_TO_JAX` for a ConvTranspose2d kernel, the
    identity for vectors. JAX dim d of a leaf is PyTorch dim ``axes[d]``."""
    out: Dict[str, Tuple[int, ...]] = {}
    for mod_name, mod in model.named_modules():
        for p_name, p in mod.named_parameters(recurse=False):
            axes = tuple(range(p.dim()))
            if p.dim() == 4:
                axes = (CONV_T_TO_JAX if isinstance(mod, torch.nn.ConvTranspose2d)
                        else CONV_TO_JAX)
            out[f"{mod_name}.{p_name}" if mod_name else p_name] = axes
    return out


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
    if UP_LEAF.match(name):  # (2, 2, Cin, Cout) -> flipped (Cin, 2, 2, Cout)
        return np.transpose(k[::-1, ::-1], (2, 0, 1, 3))
    return np.transpose(k, (3, 0, 1, 2))  # HWIO -> OHWI


def _kernel_to_jax(name: str, k: np.ndarray) -> np.ndarray:
    if k.ndim == 2:
        return k
    if UP_LEAF.match(name):
        return np.transpose(k, (1, 2, 0, 3))[::-1, ::-1]
    return np.transpose(k, (1, 2, 3, 0))


def qparams_from_numpy(tree) -> Dict:
    """A JAX qparams tree (numpy-convertible leaves) -> the port's qparams:
    ``{"layers": {... {"kernel", "w_scale", "bias"}}, "scales": {tag: 0-dim
    float32 tensor}}`` on the CPU, kernels in K2's layout."""
    def leaf(name, child):
        if "w_scale" not in child:  # an attention gate's folded float conv: OIHW
            k = np.transpose(np.asarray(child["kernel"]), (3, 2, 0, 1))
            return {"kernel": _f32(np.ascontiguousarray(k)), "bias": _f32(child["bias"])}
        k = _kernel_to_port(name, np.asarray(child["kernel"]))
        return {"kernel": torch.from_numpy(np.array(k, np.int8, order="C")),
                "w_scale": _f32(child["w_scale"]), "bias": _f32(child["bias"])}

    return {"layers": _map_layers(tree["layers"], leaf),
            "scales": {tag: _f32(v).reshape(()) for tag, v in tree["scales"].items()}}


def qparams_to_numpy(qparams) -> Dict:
    """Inverse of :func:`qparams_from_numpy`: the JAX layout, numpy leaves."""
    def leaf(name, child):
        if "w_scale" not in child:
            k = np.transpose(child["kernel"].cpu().numpy(), (2, 3, 1, 0))
            return {"kernel": np.ascontiguousarray(k), "bias": child["bias"].cpu().numpy()}
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
