"""Arithmetic the per-layer metric readers share."""

from port_bench import flops

CONV = ("xmma", "implicit", "cudnn", "conv", "grad", "fprop", "cutlass", "gemm", "sm90")
NORM = ("batch_norm", "batchnorm")
OPTIMIZER = ("adam",)


def is_glue(name: str) -> bool:
    """A device operation that is neither a cuDNN or GEMM convolution, nor
    BatchNorm, nor the optimizer: elementwise work, copies, concatenations,
    reductions and sets."""
    low = name.lower()
    return not any(k in low for k in CONV + NORM + OPTIMIZER)


def idle(ctx):
    """100 x the share of the traced window in which the device was idle:
    its length less the union of its kernels, copies and sets; None where
    the trace holds no device work."""
    return None if ctx.trace is None else ctx.trace.idle_pct()


def mfu(ctx, per_image: float, peak: float, passes: float = 1.0):
    """100 x the model FLOPs of the window's images per second over a peak."""
    return 100.0 * passes * per_image * ctx.window.images / ctx.window.seconds / peak


__all__ = ["flops", "is_glue", "idle", "mfu"]
