"""Batched anomaly-scoring engine on the GPU (counterpart of
``tpu_unet/serve.py::AnomalyScorer``).

Load a trained AnomalyUNet once, then score streams of NHWC uint8 images.
Every call runs on the engine's device (``cuda`` unless the caller asks for
``cpu``) and:

- normalizes the batch with kernel K1 (``eval_transform``);
- runs the score-only forward: encoder, reconstruction decoder and its head.
  The segmentation decoder never runs;
- in int8 (``quantize='int8'``), runs every 3x3 conv through kernel K2
  (``ops/quantize.py``), after calibrating once or loading saved qparams;
- pads ragged batches to the serving batch, or to the smallest bucket of an
  optional ``bucket_sizes`` ladder;
- enqueues batches back to back and fetches only the (N,) scores at the end.

The score compares the sigmoid reconstruction with the float32 normalized
image, as the JAX package (and the reference it follows) does.

Usage:
    scorer = AnomalyScorer.from_checkpoint("best_model.pth", quantize="int8",
                                           calib_images=calib_u8)
    scores = scorer.score_paths(glob.glob("line_camera/*.png"))
"""

from __future__ import annotations

import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence

import numpy as np
import torch

from tpu_unet_torch.core.device import resolve_device
from tpu_unet_torch.core.precision import get_policy
from tpu_unet_torch.data.transforms import load_image_rgb
from tpu_unet_torch.metrics.anomaly import anomaly_score
from tpu_unet_torch.models import build_model
from tpu_unet_torch.ops.augment import eval_transform
from tpu_unet_torch.ops.fold_bn import fold_batchnorm
from tpu_unet_torch.ops.quantize import (_QuantExec, _run, build_plan, chunk_calibration,
                                         quantize_from_train_state, tree_to)
from tpu_unet_torch.utils.weights import load_reference_checkpoint


def _latency_stats_ms(run_once, n_iters: int) -> dict:
    """p50/p95/mean wall-clock per synchronous ``run_once()`` call, in ms,
    after one unmeasured warmup call."""
    run_once()
    times = np.empty(max(n_iters, 1))
    for i in range(len(times)):
        t0 = time.perf_counter()
        run_once()
        times[i] = (time.perf_counter() - t0) * 1e3
    return {"p50_ms": round(float(np.percentile(times, 50)), 3),
            "p95_ms": round(float(np.percentile(times, 95)), 3),
            "mean_ms": round(float(times.mean()), 3)}


def _amap_to_u8(amap: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 1) sigmoid anomaly map -> (N, H, W) uint8 heatmap (0..255)."""
    a = torch.clamp(amap[..., 0].to(torch.float32), 0.0, 1.0)
    return torch.round(a * 255.0).to(torch.uint8)


def _pad_chunk(chunk: np.ndarray, batch_size: int) -> np.ndarray:
    """Zero-pad a ragged final chunk to the serving batch size."""
    if len(chunk) < batch_size:
        pad = np.zeros((batch_size - len(chunk),) + chunk.shape[1:], chunk.dtype)
        chunk = np.concatenate([chunk, pad])
    return chunk


def _normalize_buckets(bucket_sizes, batch_size: int):
    """Validate a serving-batch bucket ladder: a sorted tuple of distinct
    sizes always ending in ``batch_size``, or None when no ladder was given."""
    if not bucket_sizes:
        return None
    sizes = sorted({int(b) for b in bucket_sizes})
    if sizes[0] < 1:
        raise ValueError(f"bucket sizes must be >= 1, got {sizes[0]}")
    if sizes[-1] > batch_size:
        raise ValueError(f"bucket size {sizes[-1]} exceeds the serving "
                         f"batch_size {batch_size}")
    if sizes[-1] != batch_size:
        sizes.append(batch_size)
    return tuple(sizes)


class DecodeError(RuntimeError):
    """A source image failed to decode; ``.path`` names the offending file."""

    def __init__(self, path: str, cause: BaseException):
        super().__init__(f"failed to decode image {path!r}: {cause!r}")
        self.path = path


def _pipelined_batches(paths: Sequence[str], size_hw, batch_size: int,
                       num_workers: int, fn, on_decode_error: str = "raise",
                       log_fn=print, pad_target=None):
    """Decode path chunks and apply ``fn(padded_uint8_batch)`` to each,
    streaming: a decode pool of ``num_workers`` threads decodes while a
    separate one-thread prefetcher overlaps chunk k+1's decode with the device
    work ``fn`` enqueues for chunk k.

    A file that fails to decode raises :class:`DecodeError` naming it; with
    ``on_decode_error='skip'`` it becomes a zero image, is logged, and its
    global index is reported. Returns ``(results, failed)``: one result per
    chunk and the sorted indices of skipped paths. ``pad_target`` maps a
    chunk length to its padded batch size (default ``batch_size``).
    """
    if on_decode_error not in ("raise", "skip"):
        raise ValueError(f"on_decode_error must be 'raise' or 'skip', "
                         f"got {on_decode_error!r}")
    if pad_target is None:
        pad_target = lambda n: batch_size  # noqa: E731
    chunks = [(lo, paths[lo:lo + batch_size])
              for lo in range(0, len(paths), batch_size)]
    if not chunks:
        return [], []
    failed: list = []
    decode_pool = ThreadPoolExecutor(max_workers=max(1, num_workers))
    prefetch = ThreadPoolExecutor(max_workers=1)
    try:
        def decode_one(item):
            idx, p = item
            try:
                return load_image_rgb(p, size_hw)
            except Exception as e:  # noqa: BLE001 — named and re-raised or reported
                if on_decode_error == "raise":
                    raise DecodeError(p, e) from e
                failed.append(idx)
                log_fn(f"serve: skipping undecodable image {p!r} ({e!r})")
                return None

        def load_batch(lo: int, batch_paths: Sequence[str]) -> np.ndarray:
            imgs = list(decode_pool.map(decode_one,
                                        list(enumerate(batch_paths, start=lo))))
            filler = np.zeros((size_hw[0], size_hw[1], 3), np.uint8)
            return np.stack([im if im is not None else filler for im in imgs])

        results = []
        next_imgs = load_batch(*chunks[0])
        for i in range(len(chunks)):
            imgs = next_imgs
            future = (prefetch.submit(load_batch, *chunks[i + 1])
                      if i + 1 < len(chunks) else None)
            results.append(fn(_pad_chunk(imgs, pad_target(len(imgs)))))
            if future is not None:
                next_imgs = future.result()
        return results, sorted(failed)
    finally:
        prefetch.shutdown(wait=False)
        decode_pool.shutdown(wait=False)


def _lagged_host_fetch(device_fn):
    """Wrap a batch-enqueue fn so each batch's outputs come to the host when
    the NEXT batch is enqueued: device memory holds one batch of outputs while
    the next batch's decode and compute overlap this one's fetch. Returns
    ``(run, drain)``; ``drain()`` gives the list of per-batch host tuples."""
    pending: list = []
    host: list = []

    def _fetch_one():
        host.append(tuple(x.cpu().numpy() for x in pending.pop()))

    def run(imgs):
        out = device_fn(imgs)
        if pending:
            _fetch_one()
        pending.append(out)

    def drain():
        if pending:
            _fetch_one()
        return host

    return run, drain


class AnomalyScorer:
    """Batched anomaly scorer over a score-only forward.

    Construct with :meth:`from_checkpoint` (a reference-layout ``.pth``) or
    :meth:`from_state_dict` (in-process weights).
    """

    def __init__(self, score_fn: Callable, image_size: int, batch_size: int,
                 device, quantize: Optional[str] = None, heatmap_fn=None,
                 bucket_sizes: Optional[Sequence[int]] = None, qparams=None):
        self._score_fn = score_fn
        self._heatmap_fn = heatmap_fn
        self.image_size = int(image_size)
        self.batch_size = int(batch_size)
        self.device = resolve_device(device)
        self.quantize = quantize  # 'int8' or None (float program)
        self.qparams = qparams  # the int8 tree, for save_qparams
        self.bucket_sizes = _normalize_buckets(bucket_sizes, self.batch_size)

    def _put(self, chunk: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device)

    def _pad_target(self, n: int) -> int:
        """Smallest serving batch adequate for ``n`` images."""
        if self.bucket_sizes is None:
            return self.batch_size
        return next(b for b in self.bucket_sizes if b >= n)

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_state_dict(cls, state_dict, *, image_size: int = 256,
                        batch_size: int = 128, precision: str = "bf16",
                        quantize: Optional[str] = None,
                        calib_images: Optional[np.ndarray] = None,
                        base_features: int = 64, bilinear: bool = False,
                        qparams: Optional[dict] = None,
                        calib_percentile: Optional[float] = None,
                        with_heatmap: bool = False,
                        bucket_sizes: Optional[Sequence[int]] = None,
                        device="cuda") -> "AnomalyScorer":
        """Build a scorer from an AnomalyUNet state_dict (reference names;
        ``bilinear`` for bilinear decoders). The float programs fold BN into
        the convs (``ops/fold_bn.py``); in int8 the bilinear upsamples run as
        float islands (``ops/quantize.py``).

        ``qparams`` (from ``ops.quantize.load_qparams``) skips calibration;
        otherwise int8 calibrates on ``calib_images`` ((N, H, W, 3) uint8) in
        chunks of 16, abs-max or ``calib_percentile``. ``with_heatmap`` adds a
        second program returning (score, (H, W) uint8 anomaly heatmap) per
        image. ``bucket_sizes`` (e.g. ``(1, 4, 16)``) lets a ragged batch pad
        to the smallest adequate bucket; ``batch_size`` is the top bucket.
        """
        if quantize not in (None, "none", "int8"):
            raise ValueError(f"unsupported quantize mode {quantize!r}")
        _normalize_buckets(bucket_sizes, batch_size)  # fail before any model work
        device = resolve_device(device)
        if quantize == "int8":
            if qparams is None:
                if calib_images is None:
                    raise ValueError("int8 quantization needs calib_images "
                                     "(a (N,H,W,3) uint8 array of in-domain "
                                     "images) or a precomputed qparams tree")
                qparams = quantize_from_train_state(
                    "anomaly_unet", state_dict, chunk_calibration(calib_images, 16),
                    percentile=calib_percentile, device=device)
            qparams = tree_to(qparams, device)
            plans = {False: build_plan("anomaly_unet", score_only=True),
                     True: build_plan("anomaly_unet")}
            qexec = _QuantExec(qparams)  # keeps each leaf's constants across batches

            def forward(img, with_amap):
                return _run(qexec, img, plans[with_amap])
        else:
            model = build_model("anomaly_unet", policy=get_policy(precision),
                                base_features=base_features, bilinear=bilinear)
            model.load_state_dict(state_dict)
            fold_batchnorm(model.eval())
            model.to(device=device, memory_format=torch.channels_last)

            def forward(img, with_amap):  # NHWC in and out; NCHW views inside
                x = img.permute(0, 3, 1, 2)
                if not with_amap:
                    return model.score_forward(x).permute(0, 2, 3, 1)
                return tuple(t.permute(0, 2, 3, 1) for t in model(x))

        def score_fn(images_u8):
            img = eval_transform(images_u8)
            return anomaly_score(forward(img, False), img)

        def heatmap_fn(images_u8):
            img = eval_transform(images_u8)
            recon, amap = forward(img, True)
            return anomaly_score(recon, img), _amap_to_u8(amap)

        return cls(score_fn, image_size, batch_size, device,
                   quantize="int8" if quantize == "int8" else None,
                   heatmap_fn=heatmap_fn if with_heatmap else None,
                   bucket_sizes=bucket_sizes,
                   qparams=qparams if quantize == "int8" else None)

    @classmethod
    def from_checkpoint(cls, checkpoint: str, **kwargs) -> "AnomalyScorer":
        """Load a reference-layout ``.pth`` (``tools/export_torch_checkpoint.py``
        writes one from a JAX checkpoint); keyword arguments as
        :meth:`from_state_dict`."""
        return cls.from_state_dict(load_reference_checkpoint(checkpoint), **kwargs)

    # -- scoring ------------------------------------------------------------

    def _batches(self, images_u8: np.ndarray, fn):
        """``fn`` over padded device batches of ``images_u8``, enqueued back to back."""
        out = []
        with torch.inference_mode():
            for lo in range(0, len(images_u8), self.batch_size):
                raw = np.asarray(images_u8[lo:lo + self.batch_size])
                out.append(fn(self._put(_pad_chunk(raw, self._pad_target(len(raw))))))
        return out

    def score_array(self, images_u8: np.ndarray) -> np.ndarray:
        """Score a (N, H, W, 3) uint8 array; returns (N,) float32 scores."""
        n = len(images_u8)
        if n == 0:
            return np.zeros((0,), np.float32)
        pending = self._batches(images_u8, self._score_fn)
        return torch.cat(pending).cpu().numpy()[:n]

    def score_paths(self, paths: Sequence[str], num_workers: int = 4,
                    on_decode_error: str = "raise", return_failed: bool = False):
        """Decode, resize and score image files; returns (N,) scores.

        A corrupt file raises :class:`DecodeError` naming the path; with
        ``on_decode_error='skip'`` it is logged and its score is NaN. With
        ``return_failed=True`` returns ``(scores, failed_indices)``.
        """
        def run(imgs):
            with torch.inference_mode():
                return self._score_fn(self._put(imgs))

        pending, failed = _pipelined_batches(
            paths, (self.image_size, self.image_size), self.batch_size,
            num_workers, run, on_decode_error=on_decode_error,
            pad_target=self._pad_target)
        if not pending:
            scores = np.zeros((0,), np.float32)
            return (scores, []) if return_failed else scores
        scores = torch.cat(pending).cpu().numpy()[:len(paths)]
        if failed:
            scores = scores.copy()
            scores[np.asarray(failed)] = np.nan
        return (scores, list(failed)) if return_failed else scores

    @property
    def has_heatmap(self) -> bool:
        """True when the engine was built with ``with_heatmap=True``."""
        return self._heatmap_fn is not None

    def _require_heatmap(self):
        if self._heatmap_fn is None:
            raise RuntimeError("this engine has no heatmap program; rebuild "
                               "with with_heatmap=True")

    def heatmap_array(self, images_u8: np.ndarray):
        """(N, H, W, 3) uint8 -> (scores (N,) f32, heatmaps (N, H, W) uint8)."""
        self._require_heatmap()
        n = len(images_u8)
        hw = self.image_size
        if n == 0:
            return np.zeros((0,), np.float32), np.zeros((0, hw, hw), np.uint8)
        pending = self._batches(images_u8, self._heatmap_fn)
        scores = torch.cat([s for s, _ in pending]).cpu().numpy()[:n]
        maps = torch.cat([m for _, m in pending]).cpu().numpy()[:n]
        return scores, maps

    def heatmap_paths(self, paths: Sequence[str], num_workers: int = 4,
                      on_decode_error: str = "raise", return_failed: bool = False):
        """Decode image files and produce (scores, heatmaps), with the decode
        pipeline and failure policy of :meth:`score_paths` (skipped files:
        score NaN, heatmap zero). Outputs come to the host one batch behind."""
        self._require_heatmap()

        def device_fn(imgs):
            with torch.inference_mode():
                return self._heatmap_fn(self._put(imgs))

        run, drain = _lagged_host_fetch(device_fn)
        _, failed = _pipelined_batches(
            paths, (self.image_size, self.image_size), self.batch_size,
            num_workers, run, on_decode_error=on_decode_error,
            pad_target=self._pad_target)
        pending = drain()
        if not pending:
            hw = self.image_size
            out = (np.zeros((0,), np.float32), np.zeros((0, hw, hw), np.uint8))
            return out + ([],) if return_failed else out
        scores = np.concatenate([s for s, _ in pending])[:len(paths)]
        maps = np.concatenate([m for _, m in pending])[:len(paths)]
        if failed:
            scores, maps = scores.copy(), maps.copy()
            scores[np.asarray(failed)] = np.nan
            maps[np.asarray(failed)] = 0
        if return_failed:
            return scores, maps, list(failed)
        return scores, maps

    def warmup(self) -> None:
        """Run every serving shape once (each bucket, or the serving batch),
        for the score program and the heatmap program when present."""
        hw = self.image_size
        for b in (self.bucket_sizes or (self.batch_size,)):
            imgs = np.zeros((b, hw, hw, 3), np.uint8)
            self.score_array(imgs)
            if self._heatmap_fn is not None:
                self.heatmap_array(imgs)

    def throughput(self, n_batches: int = 10) -> float:
        """Serving throughput (img/s) on a synthetic device-resident batch:
        ``n_batches`` score calls enqueued back to back, timed to the fetch
        of their scores, after one warmup call."""
        rng = np.random.default_rng(0)
        imgs = self._put(rng.integers(
            0, 256, (self.batch_size, self.image_size, self.image_size, 3),
            dtype=np.uint8))
        with torch.inference_mode():
            self._score_fn(imgs).cpu()
            t0 = time.perf_counter()
            out = [self._score_fn(imgs) for _ in range(n_batches)]
            s = torch.cat(out).cpu().numpy()
        dt = time.perf_counter() - t0
        if not np.isfinite(s).all():
            raise RuntimeError("non-finite scores in the throughput run")
        return self.batch_size * n_batches / dt

    def latency_ms(self, n_iters: int = 50) -> dict:
        """Per-request latency (host uint8 -> host scores), ms: each iteration
        copies one serving batch to the device, scores it and fetches the
        scores. Build with ``batch_size=1`` for single-image latency. Returns
        {p50_ms, p95_ms, mean_ms}."""
        rng = np.random.default_rng(0)
        imgs = rng.integers(0, 256, (self.batch_size, self.image_size,
                                     self.image_size, 3), dtype=np.uint8)

        def run_once():
            with torch.inference_mode():
                self._score_fn(self._put(imgs)).cpu()

        return _latency_stats_ms(run_once, n_iters)
