"""The benchmark's plain reference: what the measured program computes, in
plain PyTorch, written from the published descriptions and the reference
repository's semantics. Nothing here imports the program, JAX or the JAX
package, or reads anything the program made.

- ``ladder``: the ladder UNets (SegmentationUNet, AnomalyUNet) in float32,
  BatchNorm in train and eval form, BN folding;
- ``augment``: the paired train-time augment under given draws;
- ``losses``: MSE + binary focal, class-weighted CE + Dice;
- ``adam``: Adam with L2 weight decay;
- ``int8``: post-training int8 (or int4) calibration and the integer
  arithmetic of the anomaly score path;
- ``lowp``: float8 rounding, the lower precision the controls run in.

A configuration file names its model's module here under ``reference``.
"""

import importlib


def load(name: str):
    """The reference module ``name`` of this package."""
    return importlib.import_module(f"{__name__}.{name}")


class exact_float32:
    """Turn TF32 off for float32 products and convolutions inside the block,
    and restore the settings after it."""

    def __enter__(self):
        import torch
        self._saved = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        return self

    def __exit__(self, *exc):
        import torch
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = self._saved
        return False
