"""Post-training int8 quantization for serving (counterpart of
``tpu_unet/ops/quantize.py``), for the ladder architectures ('unet',
'seg_unet', 'attn_unet', 'anomaly_unet') with transposed-conv or bilinear
decoders, and for UNet++ ('unetpp').

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
- heads (1x1 conv + sigmoid or logits): int8 matmul, float32 epilogue;
- attention gates ('attn_unet'): in float32 on the dequantized operands,
  their folded layers kept float; the gated skip requantizes straight to
  the concat scale, calibrated on the gated tensor (tag ``.../att/out``);
- bilinear decoders: the upsample is a float island on the dequantized
  tensor, requantized straight to the concat scale; the tree has no ``up``
  leaf there, which is how the executors tell the modes apart;
- UNet++: each node X[i][j] (``fuse``) requantizes its dense row and its
  level-up to one concat scale; the plan holds only the nodes that the
  requested head needs (``heads`` k < 4 with deep supervision: i + j <= k),
  and ``average`` is the accurate mode's mean of the four head logits.

Tensors flow NHWC. Trees are keyed by the JAX package's paths
('encoder/inc/conv1', ...), so calibration tags, scales and ``.npz`` files are
the same in both packages: a qparams file saved by either loads in the other.
Float trees (:func:`full_fold`) hold PyTorch layouts (OIHW, (in, out, 2, 2));
qparams trees hold K2's layout (see ``utils/weights.py``).

Every division by a scale divides by a tensor on the data's device: on CUDA
PyTorch multiplies by the reciprocal of a Python-number divisor, which is not
``jnp``'s division.

Usage:
    fparams = full_fold(model.state_dict())
    absmax  = calibrate_absmax(arch, fparams, batches)      # uint8 NHWC batches
    qparams = quantize_model(arch, fparams, absmax)
    fwd     = make_quantized_forward(arch)
    outputs = fwd(qparams, images_u8)                       # NHWC uint8 tensor
    step    = make_quantized_anomaly_eval_step()            # the eval step's outputs
    out     = step(qparams, images_u8, masks)
    seg     = make_quantized_seg_eval_step(num_classes)     # (losses, preds, cm)
"""

from __future__ import annotations

import contextlib
import os
import re
from typing import Any, Dict, Iterable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from tpu_unet_torch.core.device import resolve_device
from tpu_unet_torch.ops.augment import eval_transform
from tpu_unet_torch.ops.kernels.int8_conv import conv3x3_int8, pack_weights, pad_cout
from tpu_unet_torch.ops.resize import interp_axis, interp_rows
from tpu_unet_torch.parallel import spatial
from tpu_unet_torch.utils.weights import (CONV_BN, UP_LEAF, layout_of, qparams_from_numpy,
                                          qparams_to_numpy)

_EPS = 1e-5  # BatchNorm eps

_ARCH_HEADS = {
    "unet": (("decoder", "up", "outc", "logits"),),
    "seg_unet": (("decoder", "up", "outc", "logits"),),
    "attn_unet": (("decoder", "up", "outc", "logits"),),
    "anomaly_unet": (
        ("decoder_recon", "up_recon", "outc_recon", "sigmoid"),
        ("decoder_seg", "up_seg", "outc_seg", "sigmoid"),
    ),
}
# Architectures whose Up blocks gate the skip (models/attention.py).
_GATED_ARCHS = frozenset({"attn_unet"})
_GRID_NODE = re.compile(r"^x(\d+)_(\d+)$")  # UNet++ node names

# Heads and transposed convs pad their int8 matmul's inner dim and width to a
# multiple of this, and its rows to at least _MM_MIN_ROWS (CUDA's
# torch._int_mm needs more than 16 rows and both dims a multiple of 8).
_MM_MULTIPLE = 8
_MM_MIN_ROWS = 17


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
    by JAX paths with ``{kernel, bias}`` conv leaves in PyTorch layouts. The
    layout (bilinear decoders, UNet++'s deep supervision heads) is read from
    the state_dict's names.
    """
    sd = {k: v.detach().to(torch.float32) for k, v in state_dict.items()}
    out: Dict[str, Any] = {}
    for path, prefix, kind in layout_of(arch, sd):
        if kind not in CONV_BN:
            w = sd[f"{prefix}.weight"]
            bias = sd.get(f"{prefix}.bias", torch.zeros(w.shape[1 if kind == "up" else 0]))
            _set(out, path, {"kernel": w, "bias": bias})
            continue
        for jconv, _, tconv, tbn in CONV_BN[kind]:
            w = sd[f"{prefix}.{tconv}.weight"]
            conv_bias = sd.get(f"{prefix}.{tconv}.bias", torch.tensor(0.0))
            bn = f"{prefix}.{tbn}"
            if f"{bn}.weight" in sd:
                inv = sd[f"{bn}.weight"] * torch.rsqrt(sd[f"{bn}.running_var"] + _EPS)
                leaf = {"kernel": w * inv.view(-1, 1, 1, 1),
                        "bias": sd[f"{bn}.bias"]
                        + (conv_bias - sd[f"{bn}.running_mean"]) * inv}
            else:  # folded already
                leaf = {"kernel": w, "bias": conv_bias.expand(w.shape[0]).clone()}
            _set(out, f"{path}/{jconv}", leaf)
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
    from tpu_unet_torch.models.blocks import check_even_pad

    dh, dw = ref.shape[1] - x.shape[1], ref.shape[2] - x.shape[2]
    check_even_pad(dh)
    if dh or dw:
        x = F.pad(x, (0, 0, dw // 2, dw - dw // 2, dh // 2, dh - dh // 2))
    return x


def _upsample2x_nhwc(x: torch.Tensor) -> torch.Tensor:
    """The align-corners 2x upsample of an NHWC tensor (H, then W)."""
    return interp_axis(interp_rows(x, 2 * x.shape[1], 1), 2 * x.shape[2], 2)


def _gate_float(p, g, x, path):
    """``models/attention.py::AttentionGate`` in folded float32 form, NHWC:
    ``p`` holds the gate's folded ``{kernel, bias}`` leaves under ``path``,
    ``g`` is the coarse gating signal and ``x`` the skip. Both executors run
    it; the int8 one on dequantized operands."""
    def conv(v, leaf):
        return _nhwc(F.conv2d(_nchw(v), leaf["kernel"], leaf["bias"]))

    gp = conv(g, _get(p, f"{path}/g/conv1"))
    # W_x's stride 2 (a 1x1 kernel): the even rows and columns
    xp = conv(x[:, ::2, ::2], _get(p, f"{path}/x/conv1"))[:, :gp.shape[1], :gp.shape[2]]
    a = conv(torch.relu(gp + xp), _get(p, f"{path}/conv2"))
    alpha = interp_axis(interp_rows(torch.sigmoid(a), x.shape[1], 1), x.shape[2], 2)
    return x * alpha


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

    def _level_up(self, x, up_path):
        """The transposed conv at ``up_path``, or the bilinear upsample
        where the tree has none."""
        if not _has(self.p, up_path):
            return _upsample2x_nhwc(x)
        leaf = _get(self.p, up_path)
        return _nhwc(F.conv_transpose2d(_nchw(x), leaf["kernel"], leaf["bias"], stride=2))

    def up_block(self, x, skip, path, gated: bool = False):
        if gated:  # the gating signal is the coarse (pre-upsample) x
            skip = self._tag(f"{path}/att/out", _gate_float(self.p, x, skip, f"{path}/att"))
        y = self._tag(f"{path}/up", self._level_up(x, f"{path}/up"))
        y = _pad_to(y, skip)
        return self.double_conv(torch.cat([skip, y], dim=-1), f"{path}/conv")

    def fuse(self, below, row, path):
        """UNet++ node X[i][j] (``path`` 'x{i}_{j}'): the level-up of
        ``below`` (``up{i}_{j}``), concat with the dense row, DoubleConv."""
        y = self._tag(f"{path}/up", self._level_up(below, "up" + path[1:]))
        y = _pad_to(y, row[0])
        return self.double_conv(torch.cat(list(row) + [y], dim=-1), path)

    def head(self, x, path, activation):
        leaf = _get(self.p, f"{path}/conv")
        y = _nhwc(F.conv2d(_nchw(x), leaf["kernel"], leaf["bias"]))
        return torch.sigmoid(y) if activation == "sigmoid" else y


def _pad_matrix(k: torch.Tensor) -> torch.Tensor:
    """Zero-pad an int8 (C, K) matrix's C and K to CUDA's torch._int_mm multiple."""
    return F.pad(k, (0, -k.shape[1] % _MM_MULTIPLE, 0, -k.shape[0] % _MM_MULTIPLE))


def _int_matmul(x2d: torch.Tensor, k: torch.Tensor, n_out: int) -> torch.Tensor:
    """Exact int8 (M, C) x (Cp, K) -> int32 (M, n_out), for ``k`` padded by
    :func:`_pad_matrix` (Cp >= C, K >= n_out). CUDA's ``torch._int_mm`` also
    wants more than 16 rows and an inner dim that is a multiple of 8: ``x2d``
    is zero-padded to both here when it falls short, and zero rows and
    columns change no sum. Every device takes the same path."""
    m, c = x2d.shape
    pad_rows = max(0, _MM_MIN_ROWS - m)
    if pad_rows or c != k.shape[0]:
        x2d = F.pad(x2d, (0, k.shape[0] - c, 0, pad_rows))
    return torch._int_mm(x2d, k)[:m, :n_out]


def _gate_subtrees(node, prefix=""):
    """(path, subtree) of every attention gate (``att``) of a quantized tree."""
    for name, child in node.items():
        if name == "att":
            yield prefix + name, child
        elif "kernel" not in child:
            yield from _gate_subtrees(child, f"{prefix}{name}/")


def _skeleton(node, gates, prefix=""):
    """A quantized tree's structure with each quantized leaf empty and each
    attention gate taken from ``gates`` (path -> subtree)."""
    out = {}
    for name, child in node.items():
        path = prefix + name
        if name == "att":
            out[name] = gates[path]
        else:
            out[name] = {} if "kernel" in child else _skeleton(child, gates, path + "/")
    return out


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
        K2's layout (``pack_weights``), their Cout zero-padded to K2's
        multiple of 16 with the scale and bias (``pad_cout``); ``cout`` is the
        unpadded count. The transposed conv's (Cin, 2, 2, Cout) kernel comes
        as a (Cin, 4 * Cout) matrix, its scale and bias repeated to match;
        matrices come padded for ``_int_matmul``."""
        c = self._consts.get(path)
        if c is None:
            leaf = _get(self.layers, path)
            k, scale, bias = leaf["kernel"], s_in * leaf["w_scale"], leaf["bias"]
            cout = k.shape[0] if kind == "conv" else k.shape[-1]
            if kind == "conv":
                k = pack_weights(pad_cout(k), k.shape[3])
                scale, bias = pad_cout(scale), pad_cout(bias)
            elif kind == "up":
                k, scale, bias = k.reshape(k.shape[0], -1), scale.repeat(4), bias.repeat(4)
            if kind != "conv":
                k = _pad_matrix(k)
            c = self._consts[path] = {"kernel": k, "scale": scale, "bias": bias,
                                      "cout": cout}
        return c

    def state(self) -> Dict[str, Any]:
        """The tensors the forward reads once every layer it runs has been
        prepared (``_leaf``): the scales, each layer's constants and the
        attention gates' float leaves. :meth:`bound` runs the executor on
        another copy of them, which is how ``serve_artifact.py`` traces it."""
        return {"scales": dict(self.scales),
                "consts": {p: {k: v for k, v in c.items() if k != "cout"}
                           for p, c in self._consts.items()},
                "gates": dict(_gate_subtrees(self.layers))}

    @contextlib.contextmanager
    def bound(self, state: Dict[str, Any]):
        """Run the executor on ``state`` (the structure of :meth:`state`)
        inside the ``with`` block. Its quantized leaves are empty there, so a
        layer that was not prepared raises instead of reading the live tree."""
        saved = self.layers, self.scales, self._consts
        self.layers = _skeleton(self.layers, state["gates"])
        self.scales = state["scales"]
        self._consts = {p: {**c, "cout": saved[2][p]["cout"]}
                        for p, c in state["consts"].items()}
        try:
            yield
        finally:
            self.layers, self.scales, self._consts = saved

    @staticmethod
    def _requant(y_f32, scale, lo=-127):
        return torch.round(y_f32 / scale).clamp_(lo, 127).to(torch.int8)

    def input(self, x):
        s = self.scales["input"]
        return self._requant(x, s), s

    def double_conv(self, xs, path):
        """Two K2 convs. Under a 'space' scope each takes its input with one
        halo row above and below (a new contiguous tensor, as K2 needs)
        and keeps output rows 1..h: K2's SAME padding touches only the two
        rows that are cropped, so the rows are the whole image's."""
        x, s_in = xs
        ex = spatial.current()
        for i in (1, 2):
            c = self._leaf(f"{path}/conv{i}", s_in, "conv")
            s_out = self.scales[f"{path}/relu{i}"]
            if ex is not None:
                x = spatial.halo_rows(x, ex, dim=1)
            x = self.conv3x3(x, c["kernel"], c["scale"], c["bias"], s_out, relu=True)
            if ex is not None:
                x = x[:, 1:-1]
            if x.shape[3] != c["cout"]:  # K2's padded channels are zeros
                x = x[..., :c["cout"]].contiguous()
            s_in = s_out
        return x, s_in

    def maxpool(self, xs):
        x, s = xs
        n, h, w, c = x.shape
        x = x[:, :h // 2 * 2, :w // 2 * 2]
        # max commutes with the (monotone) quantization: scale unchanged
        return x.reshape(n, h // 2, 2, w // 2, 2, c).amax(dim=(2, 4)), s

    def _level_up(self, xs, up_path, s_cat):
        """The level-up of int8 ``xs``, requantized straight to ``s_cat``:
        the transposed conv's epilogue (one int8 matmul, then a pixel
        shuffle), or the bilinear upsample as a float island on the
        dequantized tensor where the tree has no ``up_path``."""
        x, s_in = xs
        if not _has(self.layers, up_path):
            return self._requant(_upsample2x_nhwc(x.to(torch.float32)) * s_in, s_cat)
        c = self._leaf(up_path, s_in, "up")
        n, h, w, cin = x.shape
        cout = c["cout"]
        acc = _int_matmul(x.reshape(-1, cin), c["kernel"], 4 * cout)
        y = acc.to(torch.float32) * c["scale"]
        y = y + c["bias"]
        q_up = self._requant(y, s_cat).view(n, h, w, 2, 2, cout)
        return q_up.permute(0, 1, 3, 2, 4, 5).reshape(n, 2 * h, 2 * w, cout)

    def up_block(self, xs, skips, path, gated: bool = False):
        x, s_in = xs
        skip, s_skip = skips
        # Shared concat scale: the level-up quantizes straight to it, the
        # skip requants int8 -> int8 (or, gated, from the float gate).
        s_cat = self.scales[f"{path}/cat"]
        if gated:  # the gate in float on dequantized operands
            y = _gate_float(self.layers, x.to(torch.float32) * s_in,
                            skip.to(torch.float32) * s_skip, f"{path}/att")
        else:
            y = skip.to(torch.float32) * s_skip
        q_up = _pad_to(self._level_up(xs, f"{path}/up", s_cat), skip)
        cat = torch.cat([self._requant(y, s_cat), q_up], dim=-1)
        return self.double_conv((cat, s_cat), f"{path}/conv")

    def fuse(self, below_xs, row_xs, path):
        """UNet++ node X[i][j] in int8: the level-up quantizes straight to
        the node's concat scale, and each operand of the dense row requants
        int8 -> int8 to it."""
        s_cat = self.scales[f"{path}/cat"]
        q_up = _pad_to(self._level_up(below_xs, "up" + path[1:], s_cat), row_xs[0][0])
        parts = [self._requant(r.to(torch.float32) * s_r, s_cat) for r, s_r in row_xs]
        return self.double_conv((torch.cat(parts + [q_up], dim=-1), s_cat), path)

    def head(self, xs, path, activation):
        x, s_in = xs
        c = self._leaf(f"{path}/conv", s_in, "head")
        n, h, w, cin = x.shape
        acc = _int_matmul(x.reshape(-1, cin), c["kernel"], c["cout"])
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
    gated = arch in _GATED_ARCHS
    outs = []
    for dec, up, outc, act in rows:
        prev = "x5"
        for i, skip in enumerate(("x4", "x3", "x2", "x1"), 1):
            plan.append(("up_block", f"{dec}/y{i}", prev, skip, f"{dec}/{up}{i}", gated))
            prev = f"{dec}/y{i}"
        plan.append(("head", f"out/{outc}", prev, outc, act))
        outs.append(f"out/{outc}")
    plan.append(("output", tuple(outs)))
    return tuple(plan)


def _unetpp_plan(deep_supervision: bool, heads: int):
    """The UNet++ grid: exactly the nodes the requested output needs, X[i][j]
    with i + j <= the last column (4, or ``heads`` for deep supervision's
    pruned mode), then the head: ``outc`` on X[0][4]; with deep supervision
    the average of the four heads (``heads`` 4) or head X[0][k] alone."""
    if not 1 <= heads <= 4:
        raise ValueError(f"heads must be in 1..4, got {heads}")
    max_j = heads if deep_supervision else 4
    plan = [("input", "t0")]
    prev = "t0"
    for i in range(max_j + 1):  # encoder column X[i][0]
        if i > 0:
            plan.append(("maxpool", f"p{i}", prev))
            prev = f"p{i}"
        plan.append(("double_conv", f"x{i}_0", prev, f"x{i}_0"))
        prev = f"x{i}_0"
    for j in range(1, max_j + 1):
        for i in range(0, max_j - j + 1):
            plan.append(("fuse", f"x{i}_{j}", f"x{i + 1}_{j - 1}",
                         tuple(f"x{i}_{k}" for k in range(j)), f"x{i}_{j}"))
    if not deep_supervision:
        plan.append(("head", "out", "x0_4", "outc", "logits"))
    elif heads < 4:
        plan.append(("head", "out", f"x0_{heads}", f"outc_{heads}", "logits"))
    else:
        for j in range(1, 5):
            plan.append(("head", f"out{j}", f"x0_{j}", f"outc_{j}", "logits"))
        plan.append(("average", "out", tuple(f"out{j}" for j in range(1, 5))))
    plan.append(("output", ("out",)))
    return tuple(plan)


def build_plan(arch: str, *, score_only: bool = False, deep_supervision: bool = False,
               heads: int = 4):
    """Compile an architecture name into a flat op plan. Ops: ('input', dst) |
    ('double_conv', dst, src, path) | ('maxpool', dst, src) | ('up_block', dst,
    src, skip, path, gated) | ('fuse', dst, below, (row...), path) | ('head',
    dst, src, path, act) | ('average', dst, (srcs...)) | ('output',
    (srcs...)). ``score_only`` (anomaly_unet) runs the reconstruction ladder
    alone, as the JAX score program does after dead-code elimination;
    ``deep_supervision`` and ``heads`` are UNet++'s."""
    if arch == "unetpp":
        return _unetpp_plan(deep_supervision, heads)
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
        elif kind == "fuse":
            env[op[1]] = exc.fuse(env[op[2]], [env[r] for r in op[3]], op[4])
        elif kind == "head":
            env[op[1]] = exc.head(env[op[2]], op[3], op[4])
        elif kind == "average":  # head outputs are float32 in both executors
            outs = [env[r] for r in op[2]]
            env[op[1]] = sum(outs) / len(outs)
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
                     percentile: Optional[float] = None,
                     deep_supervision: bool = False,
                     heads: int = 4) -> Dict[str, float]:
    """Per-tensor activation ranges over calibration batches of uint8 NHWC
    images, on the device ``fparams`` lie on. Abs-max by default;
    ``percentile`` (e.g. 99.9) takes that percentile of |x| per batch instead.
    Batches combine with max. The whole plan is calibrated (both AnomalyUNet
    decoders), so the scales serve the heatmap program too;
    ``deep_supervision`` and ``heads`` select UNet++'s plan (heads 4, the
    default, calibrates every node, which serves every pruned head)."""
    plan = build_plan(arch, deep_supervision=deep_supervision, heads=heads)
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
    device ``fparams`` lie on. An attention gate's subtree (``att``) stays
    in folded float32; a bilinear tree has no ``up`` leaf to quantize."""
    build_plan(arch)  # validates arch
    device = _tree_device(fparams)
    scales = {tag: _scale(v, device) for tag, v in absmax.items()
              if not tag.endswith("/up")}
    for tag, v in absmax.items():  # shared concat scales
        if tag.endswith("/up"):
            path = tag[:-3]
            m = _GRID_NODE.match(path)
            if m:  # UNet++ node: the concat fuses the dense row and the level-up
                i, j = int(m.group(1)), int(m.group(2))
                operands = [absmax[f"x{i}_{k}/relu2"] for k in range(j)] + [v]
            elif f"{path}/att/out" in absmax:  # the skip operand is the gated one
                operands = [absmax[f"{path}/att/out"], v]
            else:
                operands = [absmax[_skip_relu_tag(path)], v]
            scales[f"{path}/cat"] = _scale(max(operands), device)

    def walk(node):
        out = {}
        for name, child in node.items():
            if name == "att":
                out[name] = tree_to(child, device)  # a copy, kept float
                continue
            if "kernel" not in child:
                out[name] = walk(child)
                continue
            k = child["kernel"]
            if UP_LEAF.match(name):  # (Cin, Cout, 2, 2) -> (Cin, 2, 2, Cout)
                q, s = _quant_per_channel(k, (0, 2, 3))
                q = q.permute(0, 2, 3, 1)
            elif k.shape[2:] == (1, 1):  # head: (K, C, 1, 1) -> (C, K)
                q, s = _quant_per_channel(k, (1, 2, 3))
                q = q[:, :, 0, 0].t()
            else:  # OIHW -> OHWI
                q, s = _quant_per_channel(k, (1, 2, 3))
                q = q.permute(0, 2, 3, 1)
            out[name] = {"kernel": q.contiguous(), "w_scale": s, "bias": child["bias"].clone()}
        return out

    return {"layers": walk(fparams), "scales": scales}


def _skip_relu_tag(up_path: str) -> str:
    """The calibration tag of the skip tensor concatenated at this up block."""
    i = int(up_path.split("/")[1][-1])  # up1..up4 pair with x4..x1
    if i == 4:
        return "encoder/inc/relu2"
    return f"encoder/down{4 - i}/conv/relu2"


def make_quantized_forward(arch: str, *, score_only: bool = False,
                           deep_supervision: bool = False, heads: int = 4):
    """``fwd(qparams, images_u8) -> model outputs`` (float32 heads, NHWC).

    Output structure matches the float model's eval mode: ``(reconstruction,
    anomaly_map)`` for 'anomaly_unet' (the reconstruction alone with
    ``score_only``), logits for 'unet', 'seg_unet', 'attn_unet' and
    'unetpp' (with deep supervision the mean of the four head logits at
    ``heads`` 4, head X[0][k] alone at k < 4).
    """
    plan = build_plan(arch, score_only=score_only, deep_supervision=deep_supervision,
                      heads=heads)

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
                              device="cuda", deep_supervision: bool = False,
                              heads: int = 4) -> Dict[str, Any]:
    """One-call PTQ: fold BN, calibrate activation scales on ``device``
    (``cuda`` unless the caller asks for ``cpu``), quantize weights.
    ``deep_supervision`` and ``heads`` select UNet++'s calibration plan.
    ``state_dict`` holds whole tensors: a tensor-parallel state (or model)
    passed instead is refused, since it holds channel slices."""
    model = getattr(state_dict, "model", state_dict)
    if getattr(model, "tp_dims", None):
        raise ValueError("quantize_from_train_state: a tensor-parallel state holds channel "
                         "slices; quantize the whole weights its .pth holds "
                         "(train/checkpoint.py gathers the slices)")
    fparams = tree_to(full_fold(state_dict, arch), resolve_device(device))
    absmax = calibrate_absmax(arch, fparams, calib_batches,
                              max_batches=max_batches, percentile=percentile,
                              deep_supervision=deep_supervision, heads=heads)
    return quantize_model(arch, fparams, absmax)


def make_quantized_anomaly_eval_step(loss_cfg=None, group=None):
    """int8 drop-in for ``train/steps.py::make_anomaly_eval_step``.

    Returns ``step(qparams, images_u8, masks, valid=None)`` with the float
    eval step's output keys, so the epoch drivers and the test CLI run
    unchanged on int8 inference. The full two-decoder plan runs (26 K2
    launches per batch for AnomalyUNet), on the device the qparams lie on.
    One executor is built per step and kept while the same qparams come
    back, so each layer's constants are made once (as the scorer does).
    ``eval_transform`` runs once per batch: its output is the int8 forward's
    input and the loss's and score's reference. ``group``: the data-parallel
    process group whose global batch the loss scalars cover.
    """
    from tpu_unet_torch.losses.anomaly import combined_anomaly_loss
    from tpu_unet_torch.metrics.anomaly import anomaly_error_map, anomaly_score
    from tpu_unet_torch.train.steps import AnomalyLossConfig, _as_tensor, _group_mean

    cfg = loss_cfg if loss_cfg is not None else AnomalyLossConfig()
    plan = build_plan("anomaly_unet")
    cache: Dict[str, Any] = {}

    @torch.no_grad()
    def step(qparams, images_u8, masks, valid=None):
        if cache.get("layers") is not qparams["layers"]:
            cache["layers"], cache["exec"] = qparams["layers"], _QuantExec(qparams)
        device = _tree_device(qparams["layers"])
        img = eval_transform(_as_tensor(images_u8, device))
        recon, amap = _run(cache["exec"], img, plan)
        m = _as_tensor(masks, device).to(torch.float32)
        if valid is not None:
            valid = _as_tensor(valid, device)
        losses = combined_anomaly_loss(recon, amap, img, m, sample_weight=valid,
                                       group=group, **cfg.kwargs())
        return {
            "losses": _group_mean(losses, group),
            "score": anomaly_score(recon, img),
            "error_map": anomaly_error_map(recon, img),
            "anomaly_map": amap[..., 0],
            "reconstruction": recon,
            "image": img,
        }

    return step


def make_quantized_seg_eval_step(num_classes: int, loss_cfg=None, arch: str = "seg_unet",
                                 deep_supervision: bool = False, heads: int = 4,
                                 group=None, space=None):
    """int8 drop-in for ``train/steps.py::make_seg_eval_step``.

    Returns ``step(qparams, images_u8, labels, valid=None) -> (losses, preds,
    cm)``, the float step's contract, so ``validate_seg_epoch`` and the seg
    test CLIs run unchanged on int8 inference, on the device the qparams lie
    on. ``eval_transform`` (K1) runs once per batch and every 3x3 conv
    through K2: 18 launches per batch for SegmentationUNet and the
    attention UNet, 30 for UNet++ (6 with deep supervision and ``heads`` 1).
    One executor is kept while the same qparams come back. ``arch``
    'seg_unet', 'unet', 'attn_unet' or 'unetpp' (``deep_supervision``,
    ``heads``: see :func:`make_quantized_forward`). ``group`` and ``space``:
    as ``seg_eval_outputs``'s: under ``space`` K1 and every K2 launch run
    on the rank's rows (K2's input with its halo rows), and the predictions
    come back whole.
    """
    from tpu_unet_torch.train.steps import (SegLossConfig, _as_tensor, seg_eval_outputs,
                                            space_rows)

    cfg = loss_cfg if loss_cfg is not None else SegLossConfig()
    plan = build_plan(arch, deep_supervision=deep_supervision, heads=heads)
    cache: Dict[str, Any] = {}

    @torch.no_grad()
    def step(qparams, images_u8, labels, valid=None):
        if cache.get("layers") is not qparams["layers"]:
            cache["layers"], cache["exec"] = qparams["layers"], _QuantExec(qparams)
        device = _tree_device(qparams["layers"])
        img, lbl = space_rows(_as_tensor(images_u8, device), _as_tensor(labels, device),
                              space)
        with spatial.scope(space):
            logits = _run(cache["exec"], eval_transform(img), plan)
            if valid is not None:
                valid = _as_tensor(valid, device)
            return seg_eval_outputs(logits, lbl, num_classes, cfg, valid, group, space)

    return step


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
