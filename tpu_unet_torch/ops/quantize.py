"""Post-training int8 quantization for serving (counterpart of
``tpu_unet/ops/quantize.py``), for the ladder architectures ('unet',
'seg_unet', 'anomaly_unet') with transposed-conv decoders.

The scheme is the JAX package's, value for value:

- weights int8 with per-output-channel symmetric scales, after BN is folded
  fully into each conv (:func:`full_fold`);
- activations int8 with per-tensor scales from abs-max (or percentile)
  calibration; post-ReLU tensors live in [0, 127]; max-pool runs on int8;
- 3x3 convs: kernel K2 (``ops/kernels/int8_conv.py``), int32 accumulation and
  the requant epilogue ``relu(acc * (s_in * w_scale) + b) -> round(y / s_out)``
  in registers;
- the k2s2 transposed conv: one int8 matmul (``torch._int_mm``) of the
  (N*H*W, Cin) input by the (Cin, 4*Cout) kernel, the epilogue requantizing
  straight to the skip concat's shared scale, then a pixel shuffle;
- the skip concat: the skip requantizes int8 -> int8 to that shared scale;
- heads (1x1 conv + sigmoid or logits): int8 matmul, float32 epilogue.

Tensors flow NHWC. Trees are keyed by the JAX package's paths
('encoder/inc/conv1', ...), so calibration tags, scales and ``.npz`` files are
the same in both packages: a qparams file saved by either loads in the other.
Float trees (:func:`full_fold`) hold PyTorch layouts (OIHW, (in, out, 2, 2));
qparams trees hold K2's layout (see ``utils/weights.py``).

Every division by a scale divides by a tensor on the data's device: on CUDA
PyTorch multiplies by the reciprocal of a Python-number divisor, which is not
``jnp``'s division.

UNet++, attention gates and bilinear decoders (float islands) are not ported.

Usage:
    fparams = full_fold(model.state_dict())
    absmax  = calibrate_absmax(arch, fparams, batches)      # uint8 NHWC batches
    qparams = quantize_model(arch, fparams, absmax)
    fwd     = make_quantized_forward(arch)
    outputs = fwd(qparams, images_u8)                       # NHWC uint8 tensor
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tpu_unet_torch.core.device import resolve_device
from tpu_unet_torch.ops.augment import eval_transform
from tpu_unet_torch.ops.kernels.int8_conv import conv3x3_int8, pack_weights
from tpu_unet_torch.utils.weights import (ladder_layout, qparams_from_numpy,
                                          qparams_to_numpy)

_EPS = 1e-5  # BatchNorm eps

_ARCH_HEADS = {
    "unet": (("decoder", "up", "outc", "logits"),),
    "seg_unet": (("decoder", "up", "outc", "logits"),),
    "anomaly_unet": (
        ("decoder_recon", "up_recon", "outc_recon", "sigmoid"),
        ("decoder_seg", "up_seg", "outc_seg", "sigmoid"),
    ),
}

# Heads and transposed convs pad their int8 matmul's width to a multiple of
# this (CUDA's torch._int_mm needs it).
_MM_MULTIPLE = 8


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _nhwc(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 2, 3, 1)


def _get(tree: Dict[str, Any], path: str) -> Any:
    node = tree
    for part in path.split("/"):
        node = node[part]
    return node


def _set(tree: Dict[str, Any], path: str, value: Any) -> None:
    parts = path.split("/")
    for part in parts[:-1]:
        tree = tree.setdefault(part, {})
    tree[parts[-1]] = value


def _has(tree: Dict[str, Any], path: str) -> bool:
    node = tree
    for part in path.split("/"):
        if not isinstance(node, dict) or part not in node:
            return False
        node = node[part]
    return True


def tree_to(tree, device) -> Any:
    """Move every tensor of a nested dict to ``device``."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    return tree.to(device) if isinstance(tree, torch.Tensor) else tree


def _tree_device(tree) -> torch.device:
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.device


# ---------------------------------------------------------------------------
# Full BN fold
# ---------------------------------------------------------------------------

@torch.no_grad()
def full_fold(state_dict: Dict[str, torch.Tensor],
              arch: str = "anomaly_unet") -> Dict[str, Any]:
    """Fold BN completely into conv kernels and biases; float32 leaves.

    Takes the port's (reference-named) state_dict, unfolded or already folded
    by ``ops/fold_bn.py``, and returns the quantizer's float form: a tree keyed
    by JAX paths with ``{kernel, bias}`` conv leaves in PyTorch layouts.
    """
    sd = {k: v.detach().to(torch.float32) for k, v in state_dict.items()}
    out: Dict[str, Any] = {}
    for path, prefix, kind in ladder_layout(arch):
        if kind != "double":
            w = sd[f"{prefix}.weight"]
            bias = sd.get(f"{prefix}.bias", torch.zeros(w.shape[1 if kind == "up" else 0]))
            _set(out, path, {"kernel": w, "bias": bias})
            continue
        for i, (ci, bi) in enumerate(((0, 1), (3, 4)), start=1):
            w = sd[f"{prefix}.double_conv.{ci}.weight"]
            conv_bias = sd.get(f"{prefix}.double_conv.{ci}.bias", torch.tensor(0.0))
            bn = f"{prefix}.double_conv.{bi}"
            if f"{bn}.weight" in sd:
                inv = sd[f"{bn}.weight"] * torch.rsqrt(sd[f"{bn}.running_var"] + _EPS)
                leaf = {"kernel": w * inv.view(-1, 1, 1, 1),
                        "bias": sd[f"{bn}.bias"]
                        + (conv_bias - sd[f"{bn}.running_mean"]) * inv}
            else:  # folded already
                leaf = {"kernel": w, "bias": conv_bias.expand(w.shape[0]).clone()}
            _set(out, f"{path}/conv{i}", leaf)
    return out


# ---------------------------------------------------------------------------
# Executors (float calibration and int8) and the plan that drives them
# ---------------------------------------------------------------------------

def _percentile(a: torch.Tensor, q: float) -> torch.Tensor:
    """``jnp.percentile(a, q)`` (linear interpolation) of a whole tensor."""
    flat = torch.sort(a.reshape(-1).to(torch.float64)).values
    pos = (flat.numel() - 1) * q / 100.0
    lo = int(np.floor(pos))
    hi = min(lo + 1, flat.numel() - 1)
    return flat[lo] + (flat[hi] - flat[lo]) * (pos - lo)


def _pad_to(x: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Static pad of NHWC x up to ref's spatial dims (models/blocks.py::Up)."""
    dh, dw = ref.shape[1] - x.shape[1], ref.shape[2] - x.shape[2]
    if dh or dw:
        x = F.pad(x, (0, 0, dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
    return x


class _CalibExec:
    """Float forward over the folded tree; records each tensor's range
    (abs-max, or a percentile of |x|)."""

    def __init__(self, fparams, percentile: Optional[float] = None):
        self.p = fparams
        self.percentile = percentile
        self.absmax: Dict[str, torch.Tensor] = {}

    def _tag(self, tag, x):
        a = torch.abs(x)
        self.absmax[tag] = (_percentile(a, self.percentile) if self.percentile is not None
                            else torch.amax(a)).to(torch.float32)
        return x

    def input(self, x):
        return self._tag("input", x)

    def double_conv(self, x, path):
        for i in (1, 2):
            leaf = _get(self.p, f"{path}/conv{i}")
            x = torch.relu(_nhwc(F.conv2d(_nchw(x), leaf["kernel"], leaf["bias"],
                                          padding=1)))
            x = self._tag(f"{path}/relu{i}", x)
        return x

    def maxpool(self, x):
        return _nhwc(F.max_pool2d(_nchw(x), 2))

    def up_block(self, x, skip, path, gated: bool = False):
        if gated or not _has(self.p, f"{path}/up"):
            raise NotImplementedError("attention gates and bilinear decoders "
                                      "are not ported yet")
        leaf = _get(self.p, f"{path}/up")
        y = _nhwc(F.conv_transpose2d(_nchw(x), leaf["kernel"], leaf["bias"], stride=2))
        y = self._tag(f"{path}/up", y)
        y = _pad_to(y, skip)
        return self.double_conv(torch.cat([skip, y], dim=-1), f"{path}/conv")

    def head(self, x, path, activation):
        leaf = _get(self.p, f"{path}/conv")
        y = _nhwc(F.conv2d(_nchw(x), leaf["kernel"], leaf["bias"]))
        return torch.sigmoid(y) if activation == "sigmoid" else y


def _pad_cols(k: torch.Tensor) -> torch.Tensor:
    """Zero-pad an int8 (C, K) matrix's K to CUDA's torch._int_mm multiple."""
    pad = -k.shape[1] % _MM_MULTIPLE
    return F.pad(k, (0, pad)) if pad else k


def _int_matmul(x2d: torch.Tensor, k: torch.Tensor, n_out: int) -> torch.Tensor:
    """Exact int8 (M, C) x (C, K) -> int32 (M, n_out), K >= n_out (padded columns)."""
    return torch._int_mm(x2d, k)[:, :n_out]


class _QuantExec:
    """int8 forward over the quantized tree. Tensors flow as (q_int8, scale)
    with NHWC int8 data and 0-dim float32 scales on the same device."""

    conv3x3 = staticmethod(conv3x3_int8)  # chip_smoke.py swaps in the plain version

    def __init__(self, qparams):
        self.layers = qparams["layers"]
        self.scales = qparams["scales"]
        self._consts: Dict[str, Dict[str, torch.Tensor]] = {}

    def _leaf(self, path, s_in, kind):
        """A layer's kernel, combined scale ``s_in * w_scale`` and bias in the
        form its op takes, made on the layer's first call and kept: a layer's
        input scale is the same on every call. 3x3 kernels come packed in
        K2's layout (``pack_weights``); the transposed conv's (Cin, 2, 2, Cout) kernel
        comes as a (Cin, 4 * Cout) matrix, its scale and bias repeated to match;
        matrices come with their columns padded for ``_int_matmul``."""
        c = self._consts.get(path)
        if c is None:
            leaf = _get(self.layers, path)
            k, scale, bias = leaf["kernel"], s_in * leaf["w_scale"], leaf["bias"]
            if kind == "conv":
                k = pack_weights(k, k.shape[3])
            elif kind == "up":
                k, scale, bias = k.reshape(k.shape[0], -1), scale.repeat(4), bias.repeat(4)
            if kind != "conv":
                k = _pad_cols(k)
            c = self._consts[path] = {"kernel": k, "scale": scale, "bias": bias}
        return c

    @staticmethod
    def _requant(y_f32, scale, lo=-127):
        return torch.round(y_f32 / scale).clamp_(lo, 127).to(torch.int8)

    def input(self, x):
        s = self.scales["input"]
        return self._requant(x, s), s

    def double_conv(self, xs, path):
        x, s_in = xs
        for i in (1, 2):
            c = self._leaf(f"{path}/conv{i}", s_in, "conv")
            s_out = self.scales[f"{path}/relu{i}"]
            x = self.conv3x3(x, c["kernel"], c["scale"], c["bias"], s_out, relu=True)
            s_in = s_out
        return x, s_in

    def maxpool(self, xs):
        x, s = xs
        n, h, w, c = x.shape
        x = x[:, :h // 2 * 2, :w // 2 * 2]
        # max commutes with the (monotone) quantization: scale unchanged
        return x.reshape(n, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4)), s

    def up_block(self, xs, skips, path, gated: bool = False):
        if gated or not _has(self.layers, f"{path}/up"):
            raise NotImplementedError("attention gates and bilinear decoders "
                                      "are not ported yet")
        x, s_in = xs
        skip, s_skip = skips
        c = self._leaf(f"{path}/up", s_in, "up")
        n, h, w, cin = x.shape
        cout = c["bias"].numel() // 4
        acc = _int_matmul(x.reshape(-1, cin), c["kernel"], 4 * cout)
        y = acc.to(torch.float32) * c["scale"]
        y = y + c["bias"]
        # Shared concat scale: the transposed conv's epilogue quantizes
        # straight to it, the skip requants int8 -> int8.
        s_cat = self.scales[f"{path}/cat"]
        q_up = self._requant(y, s_cat).view(n, h, w, 2, 2, cout)
        q_up = q_up.permute(0, 1, 3, 2, 4, 5).reshape(n, 2 * h, 2 * w, cout)
        q_up = _pad_to(q_up, skip)
        q_skip = self._requant(skip.to(torch.float32) * s_skip, s_cat)
        cat = torch.cat([q_skip, q_up], dim=-1)
        return self.double_conv((cat, s_cat), f"{path}/conv")

    def head(self, xs, path, activation):
        x, s_in = xs
        c = self._leaf(f"{path}/conv", s_in, "head")
        n, h, w, cin = x.shape
        acc = _int_matmul(x.reshape(-1, cin), c["kernel"], c["bias"].numel())
        y = acc.to(torch.float32) * c["scale"] + c["bias"]
        y = y.reshape(n, h, w, -1)
        return torch.sigmoid(y) if activation == "sigmoid" else y


def _ladder_plan(arch: str, score_only: bool = False):
    """One shared encoder, one decoder ladder per _ARCH_HEADS row (AnomalyUNet
    has two; ``score_only`` keeps the reconstruction ladder alone)."""
    plan = [("input", "x0"), ("double_conv", "x1", "x0", "encoder/inc")]
    for i in (1, 2, 3, 4):
        plan += [("maxpool", f"p{i}", f"x{i}"),
                 ("double_conv", f"x{i + 1}", f"p{i}", f"encoder/down{i}/conv")]
    rows = _ARCH_HEADS[arch][:1] if score_only else _ARCH_HEADS[arch]
    outs = []
    for dec, up, outc, act in rows:
        prev = "x5"
        for i, skip in enumerate(("x4", "x3", "x2", "x1"), 1):
            plan.append(("up_block", f"{dec}/y{i}", prev, skip, f"{dec}/{up}{i}", False))
            prev = f"{dec}/y{i}"
        plan.append(("head", f"out/{outc}", prev, outc, act))
        outs.append(f"out/{outc}")
    plan.append(("output", tuple(outs)))
    return tuple(plan)


def build_plan(arch: str, *, score_only: bool = False):
    """Compile an architecture name into a flat op plan. Ops: ('input', dst) |
    ('double_conv', dst, src, path) | ('maxpool', dst, src) | ('up_block', dst,
    src, skip, path, gated) | ('head', dst, src, path, act) | ('output',
    (srcs...)). ``score_only`` (anomaly_unet) runs the reconstruction ladder
    alone, as the JAX score program does after dead-code elimination."""
    if arch in ("unetpp", "attn_unet"):
        raise NotImplementedError(f"int8 {arch!r} is not ported yet")
    if arch not in _ARCH_HEADS:
        raise ValueError(f"unknown arch {arch!r}")
    return _ladder_plan(arch, score_only)


def _run(exc, x, plan):
    """Drive one executor (float calibration or int8) through a plan (an
    architecture name or a prebuilt one from build_plan)."""
    if isinstance(plan, str):
        plan = build_plan(plan)
    env: Dict[str, Any] = {}
    for op in plan:
        kind = op[0]
        if kind == "input":
            env[op[1]] = exc.input(x)
        elif kind == "double_conv":
            env[op[1]] = exc.double_conv(env[op[2]], op[3])
        elif kind == "maxpool":
            env[op[1]] = exc.maxpool(env[op[2]])
        elif kind == "up_block":
            env[op[1]] = exc.up_block(env[op[2]], env[op[3]], op[4], gated=op[5])
        elif kind == "head":
            env[op[1]] = exc.head(env[op[2]], op[3], op[4])
        elif kind == "output":
            outs = [env[r] for r in op[1]]
            return outs[0] if len(outs) == 1 else tuple(outs)
        else:
            raise ValueError(f"unknown plan op {kind!r}")
    raise ValueError("plan has no ('output', ...) op")


# ---------------------------------------------------------------------------
# Calibration and quantization
# ---------------------------------------------------------------------------

@torch.no_grad()
def calibrate_absmax(arch: str, fparams: Dict[str, Any],
                     batches: Iterable[np.ndarray],
                     max_batches: int = 8,
                     percentile: Optional[float] = None) -> Dict[str, float]:
    """Per-tensor activation ranges over calibration batches of uint8 NHWC
    images, on the device ``fparams`` lie on. Abs-max by default;
    ``percentile`` (e.g. 99.9) takes that percentile of |x| per batch instead.
    Batches combine with max. The whole plan is calibrated (both AnomalyUNet
    decoders), so the scales serve the heatmap program too."""
    plan = build_plan(arch)
    device = _tree_device(fparams)
    absmax: Dict[str, float] = {}
    for i, images in enumerate(batches):
        if i >= max_batches:
            break
        exc = _CalibExec(fparams, percentile=percentile)
        x = torch.from_numpy(np.ascontiguousarray(images)).to(device)
        _run(exc, eval_transform(x), plan)
        values = torch.stack(list(exc.absmax.values())).tolist()
        for tag, v in zip(exc.absmax, values):
            absmax[tag] = max(absmax.get(tag, 0.0), v)
    if not absmax:
        raise ValueError("calibration saw no batches")
    return absmax


def _scale(v: float, device) -> torch.Tensor:
    return torch.tensor(np.float32(max(v, 1e-12) / 127.0), device=device)


@torch.no_grad()
def _quant_per_channel(kernel: torch.Tensor, dims) -> Tuple[torch.Tensor, torch.Tensor]:
    amax = torch.clamp_min(torch.amax(torch.abs(kernel), dim=dims), 1e-12)
    s = amax / torch.full((), 127.0, device=kernel.device)
    shape = [-1 if d not in dims else 1 for d in range(kernel.dim())]
    q = torch.round(kernel / s.view(shape)).clamp_(-127, 127).to(torch.int8)
    return q, s


@torch.no_grad()
def quantize_model(arch: str, fparams: Dict[str, Any],
                   absmax: Dict[str, float]) -> Dict[str, Any]:
    """Build the int8 tree that make_quantized_forward consumes, on the
    device ``fparams`` lie on."""
    build_plan(arch)  # validates arch
    device = _tree_device(fparams)
    scales = {tag: _scale(v, device) for tag, v in absmax.items()
              if not tag.endswith("/up")}
    for tag, v in absmax.items():  # shared concat scales
        if tag.endswith("/up"):
            path = tag[:-3]
            scales[f"{path}/cat"] = _scale(max(absmax[_skip_relu_tag(path)], v), device)

    layers: Dict[str, Any] = {}
    for path, _, kind in ladder_layout(arch):
        leaves = ([(f"{path}/conv1", "conv"), (f"{path}/conv2", "conv")]
                  if kind == "double" else [(path, kind)])
        for leaf_path, leaf_kind in leaves:
            leaf = _get(fparams, leaf_path)
            k = leaf["kernel"]
            if leaf_kind == "up":  # (Cin, Cout, 2, 2) -> (Cin, 2, 2, Cout)
                q, s = _quant_per_channel(k, (0, 2, 3))
                q = q.permute(0, 2, 3, 1)
            elif leaf_kind == "head":  # (K, C, 1, 1) -> (C, K)
                q, s = _quant_per_channel(k, (1, 2, 3))
                q = q[:, :, 0, 0].t()
            else:  # OIHW -> OHWI
                q, s = _quant_per_channel(k, (1, 2, 3))
                q = q.permute(0, 2, 3, 1)
            _set(layers, leaf_path, {"kernel": q.contiguous(), "w_scale": s,
                                     "bias": leaf["bias"].clone()})
    return {"layers": layers, "scales": scales}


def _skip_relu_tag(up_path: str) -> str:
    """The calibration tag of the skip tensor concatenated at this up block."""
    i = int(up_path.split("/")[1][-1])  # up1..up4 pair with x4..x1
    if i == 4:
        return "encoder/inc/relu2"
    return f"encoder/down{4 - i}/conv/relu2"


def make_quantized_forward(arch: str, *, score_only: bool = False):
    """``fwd(qparams, images_u8) -> model outputs`` (float32 heads, NHWC).

    Output structure matches the float model's eval mode: ``(reconstruction,
    anomaly_map)`` for 'anomaly_unet' (the reconstruction alone with
    ``score_only``), logits for 'unet'/'seg_unet'.
    """
    plan = build_plan(arch, score_only=score_only)

    @torch.no_grad()
    def fwd(qparams, images_u8):
        return _run(_QuantExec(qparams), eval_transform(images_u8), plan)

    return fwd


def chunk_calibration(images: np.ndarray, chunk: int = 16):
    """Split calibration images into equal-size chunks, dropping the ragged
    tail (the JAX package's batching, so both calibrate on the same batches).
    At least one chunk is kept, shrunk to len(images) if needed."""
    n = len(images)
    if n == 0:
        raise ValueError("no calibration images")
    chunk = min(chunk, n)
    usable = (n // chunk) * chunk
    return [images[i:i + chunk] for i in range(0, usable, chunk)]


def quantize_from_train_state(arch: str, state_dict: Dict[str, torch.Tensor],
                              calib_batches: Iterable[np.ndarray],
                              max_batches: int = 8,
                              percentile: Optional[float] = None,
                              device="cuda") -> Dict[str, Any]:
    """One-call PTQ: fold BN, calibrate activation scales on ``device``
    (``cuda`` unless the caller asks for ``cpu``), quantize weights."""
    fparams = tree_to(full_fold(state_dict, arch), resolve_device(device))
    absmax = calibrate_absmax(arch, fparams, calib_batches,
                              max_batches=max_batches, percentile=percentile)
    return quantize_model(arch, fparams, absmax)


def save_qparams(qparams: Dict[str, Any], path: str) -> None:
    """Persist a quantized tree as one ``.npz`` in the JAX package's layout
    (``layers/...`` keys, HWIO kernels, ``scales|<tag>`` keys)."""
    tree = qparams_to_numpy(qparams)
    flat: Dict[str, np.ndarray] = {}

    def walk(node, prefix):
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v, f"{prefix}{k}/")
            else:
                flat[f"{prefix}{k}"] = np.asarray(v)

    walk(tree["layers"], "layers/")
    for tag, v in tree["scales"].items():
        flat[f"scales|{tag}"] = np.asarray(v)
    if os.path.dirname(path):
        os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez(path, **flat)


def load_qparams(path: str) -> Dict[str, Any]:
    """Read a qparams ``.npz`` written by either package; CPU tensors in the
    port's layout."""
    with np.load(path) as data:
        tree: Dict[str, Any] = {"layers": {}, "scales": {}}
        for key in data.files:
            if key.startswith("scales|"):
                tree["scales"][key[len("scales|"):]] = data[key]
                continue
            node = tree
            parts = key.split("/")
            for p in parts[:-1]:
                node = node.setdefault(p, {})
            node[parts[-1]] = data[key]
    return qparams_from_numpy(tree)
