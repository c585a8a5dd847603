"""Batched serving engines on the GPU (counterpart of ``tpu_unet/serve.py``).

- :class:`AnomalyScorer` loads a trained AnomalyUNet once and scores streams
  of NHWC uint8 images;
- :class:`SegmentationPredictor` loads a segmentation model (SegmentationUNet,
  UNet++ with its pruned heads, the attention UNet) and predicts per-image
  class masks and a mean confidence, optionally over a tile grid at the
  images' native resolution (``ops/tiling.py``).

Every call runs on the engine's device (``cuda`` unless the caller asks for
``cpu``), in inference mode and on that device whatever thread calls it,
and:

- normalizes the batch with kernel K1 (``eval_transform``);
- runs the forward in f32 or bf16 with BN folded into the convs, or in int8
  (``quantize='int8'``) with every 3x3 conv through kernel K2
  (``ops/quantize.py``), after calibrating once or loading saved qparams.
  The scorer's score program runs the encoder, the reconstruction decoder
  and its head; the segmentation decoder never runs;
- pads ragged batches to the serving batch, or to the smallest bucket of an
  optional ``bucket_sizes`` ladder;
- enqueues batches back to back and fetches only the results.

Each call of an ``*_array`` or ``*_paths`` method is one ``serve.request``
span, over ``serve.put`` (each upload), ``serve.k1``, ``serve.forward``,
``serve.head`` and ``serve.fetch`` (``utils/spans.py``; recorded only under
a profiler or ``spans.recording()``).

The anomaly score compares the sigmoid reconstruction with the float32
normalized image, as the JAX package (and the reference it follows) does.
An engine keeps the tensors its forward reads and a way to run it on
another copy of them, which ``serve_artifact.py`` uses to export it.

``n_devices`` (or an explicit ``devices`` list) holds one replica per
device in this one process, as the JAX engine shards a batch over its
devices: each batch splits into contiguous chunks, each chunk runs on its
replica's device on that replica's own CUDA stream (K1 and K2 on every
replica), and the outputs are concatenated in order on the first device.
The batch and each bucket must divide by the replica count.
:class:`SegmentationPredictor` also takes ``n_space``: each replica then
spans ``n_space`` devices (``n_devices`` x ``n_space`` in all, the JAX
predictor's (data, space) mesh), one thread per device runs the ordinary
forward on its block of the image's rows under a ``parallel/spatial.py``
scope, the threads swap their edge rows at a barrier for every halo, and
the rows' logits are gathered on the replica's first device before the
masks and confidences are taken.

Usage:
    scorer = AnomalyScorer.from_checkpoint("best_model.pth", quantize="int8",
                                           calib_images=calib_u8)
    scores = scorer.score_paths(glob.glob("line_camera/*.png"))
    predictor = SegmentationPredictor.from_checkpoint("best_model.pth", num_classes=4)
    masks, confidences = predictor.predict_paths(paths)
"""

from __future__ import annotations

import contextlib
import itertools
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Optional, Sequence

import numpy as np
import torch
from torch.nn.utils.stateless import _reparametrize_module

from tpu_unet_torch.core.device import resolve_device
from tpu_unet_torch.core.precision import get_policy
from tpu_unet_torch.data.transforms import load_image_rgb
from tpu_unet_torch.metrics.anomaly import anomaly_score
from tpu_unet_torch.models import build_model
from tpu_unet_torch.models.unet import trains_only
from tpu_unet_torch.ops.augment import eval_transform
from tpu_unet_torch.ops.fold_bn import fold_batchnorm
from tpu_unet_torch.ops.kernels import build
from tpu_unet_torch.ops.quantize import (_QuantExec, _run, build_plan, chunk_calibration,
                                         quantize_from_train_state, tree_to)
from tpu_unet_torch.ops.seg_head import sliced_pred_confidence
from tpu_unet_torch.ops.tiling import make_tiled_logits_fn
from tpu_unet_torch.parallel import spatial
from tpu_unet_torch.parallel.mesh import local_rank_devices
from tpu_unet_torch.utils.spans import span
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


def _normalize_buckets(bucket_sizes, batch_size: int, n_data: int = 1):
    """Validate a serving-batch bucket ladder: a sorted tuple of distinct
    sizes always ending in ``batch_size``, or None when no ladder was given.
    The batch and every bucket must divide by ``n_data``, the replicas a
    batch splits over."""
    if batch_size % n_data:
        raise ValueError(f"batch_size {batch_size} not divisible by "
                         f"n_devices {n_data}")
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
    bad = [b for b in sizes if b % n_data]
    if bad:
        raise ValueError(f"bucket sizes {bad} not divisible by the "
                         f"data-parallel degree {n_data}")
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
        with span("serve.fetch"):
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


def _replica_devices(n_devices: Optional[int], devices, device,
                     n_space: int = 1) -> list:
    """The devices an engine holds a replica on, ``n_space`` consecutive
    ones per replica: ``devices`` as given, else ``n_devices`` (default 1)
    times ``n_space`` of ``device``'s type (one GPU each; more than there
    are raises; on the CPU every replica shares it)."""
    if n_space < 1:
        raise ValueError(f"n_space must be >= 1, got {n_space}")
    if devices is not None:
        devices = [resolve_device(d) for d in devices]
        if len(devices) % n_space or n_devices not in (None, len(devices) // n_space):
            raise ValueError(f"n_devices={n_devices} x n_space={n_space} but "
                             f"{len(devices)} devices given")
        return devices
    device = resolve_device(device)
    if (n_devices or 1) * n_space == 1:
        return [device]
    return local_rank_devices(n_devices or 1, device.type, n_space=n_space)


def _row_sharded(fns: list, devices: list):
    """One batch function over ``len(fns)`` space devices: thread i takes
    block i of the batch's rows (NHWC, on ``devices[0]``), runs ``fns[i]``
    on ``devices[i]`` (on a stream of its own there) under a
    ``parallel/spatial.py`` scope of a :class:`~tpu_unet_torch.parallel.
    spatial.ThreadRing`, and the blocks of the NHWC outputs are concatenated
    on ``devices[0]``. A failed thread breaks the ring's barrier, so the
    others raise instead of waiting."""
    n, home = len(fns), devices[0]
    streams = [torch.cuda.Stream(device=d) if d.type == "cuda" else None for d in devices]
    pool = ThreadPoolExecutor(max_workers=n, thread_name_prefix="space")

    def run(images_u8):
        spatial.check_rows(images_u8.shape[1], n)
        ring, h = spatial.ThreadRing(n), images_u8.shape[1] // n
        src = torch.cuda.current_stream(home) if home.type == "cuda" else None

        def work(i):
            dev, stream = devices[i], streams[i]
            try:
                with torch.inference_mode(), \
                        spatial.scope(ring.exchanger(i), images_u8.shape[1]), \
                        (torch.cuda.device(dev) if stream is not None
                         else contextlib.nullcontext()), \
                        (torch.cuda.stream(stream) if stream is not None
                         else contextlib.nullcontext()):
                    if stream is not None:
                        stream.wait_stream(src)
                    x = images_u8[:, i * h:(i + 1) * h].to(dev, copy=True)
                    return fns[i](x)
            except BaseException:
                ring.abort()
                raise

        outs = [f.result() for f in [pool.submit(work, i) for i in range(n)]]
        if src is not None:
            for stream in streams:
                src.wait_stream(stream)
            for o in outs:
                if o.device == home:
                    o.record_stream(src)
        return torch.cat([o.to(home) for o in outs], dim=1)

    return run


def _replicated(fns: list, devices: list):
    """One batch function over per-replica functions: the batch (on
    ``devices[0]``) splits into contiguous chunks, chunk i runs ``fns[i]`` on
    ``devices[i]`` on a stream of its own, and the outputs (a tensor or a
    tuple of them) are concatenated in order on ``devices[0]``. The first
    device's stream waits for every replica's before it reads the outputs."""
    if len(fns) == 1:
        return fns[0]
    home = devices[0]
    streams = [torch.cuda.Stream(device=d) if d.type == "cuda" else None for d in devices]

    def run(images_u8):
        outs = []
        src = torch.cuda.current_stream(home) if home.type == "cuda" else None
        for fn, dev, stream, x in zip(fns, devices, streams, images_u8.chunk(len(fns))):
            if stream is None:
                outs.append(fn(x.to(dev)))
                continue
            with torch.cuda.device(dev), torch.cuda.stream(stream):
                stream.wait_stream(src)
                if dev == home:  # another card's copy orders both streams itself
                    x.record_stream(stream)
                outs.append(fn(x.to(dev, non_blocking=True)))
        if src is not None:
            for stream in streams:
                src.wait_stream(stream)
        parts = [o if isinstance(o, tuple) else (o,) for o in outs]
        for part in parts:
            for t in part:
                if t.device == home and src is not None:
                    t.record_stream(src)
        cat = tuple(torch.cat([p[k].to(home) for p in parts]) for k in range(len(parts[0])))
        return cat if isinstance(outs[0], tuple) else cat[0]

    return run


def _module_state(model: torch.nn.Module):
    """An engine's export state for a float forward over ``model``:
    ``(params(), bind(params))``, the module's parameters and buffers and a
    context that runs the module on another copy of them."""
    def params():
        return {k: v.detach() for k, v in itertools.chain(model.named_parameters(),
                                                          model.named_buffers())}

    return params, lambda p: _reparametrize_module(model, p)


def _float_model(name: str, state_dict, policy_name: str, fold_bn: bool, device, **kw):
    """``name`` built under the ``policy_name`` precision policy with
    ``state_dict`` loaded, in eval mode, BN folded when ``fold_bn``, on
    ``device`` in channels_last. On a CUDA device the kernels its forward
    launches are built first, one nvcc each, started together: K1 and, for
    a folded bf16 model, the blocks' epilogue."""
    policy = get_policy(policy_name)
    if torch.device(device).type == "cuda":
        fused = fold_bn and policy.compute_dtype == torch.bfloat16
        build.build(["normalize_u8"] + (["bias_relu_bf16"] if fused else []))
    model = build_model(name, policy=policy, **kw)
    model.load_state_dict(state_dict)
    model.eval()
    if fold_bn:
        fold_batchnorm(model)
    return model.to(device=device, memory_format=torch.channels_last)


class _Engine:
    """What both engines share: the device (the first replica's), the
    replicas' devices, the serving batch and its bucket ladder, the
    per-thread serving context, and the export state."""

    def __init__(self, batch_size: int, device, bucket_sizes, export_state,
                 devices: Optional[Sequence] = None, n_space: int = 1):
        self.batch_size = int(batch_size)
        self.device = resolve_device(device)
        self.devices = [resolve_device(d) for d in devices] if devices else [self.device]
        self.n_space = n_space
        self.bucket_sizes = _normalize_buckets(bucket_sizes, self.batch_size,
                                               len(self.devices) // n_space)
        # (params(), bind(params)) for serve_artifact.export_artifact; None for
        # an engine loaded from an artifact.
        self._export_state = export_state

    def _put(self, chunk: np.ndarray) -> torch.Tensor:
        with span("serve.put"):
            return torch.from_numpy(np.ascontiguousarray(chunk)).to(self.device)

    def _pad_target(self, n: int) -> int:
        """Smallest serving batch adequate for ``n`` images."""
        if self.bucket_sizes is None:
            return self.batch_size
        return next(b for b in self.bucket_sizes if b >= n)

    @contextlib.contextmanager
    def _serving(self):
        """Inference mode on the engine's CUDA device. Both are per thread,
        and the HTTP daemon calls the engine from its batching thread."""
        cuda = self.device.type == "cuda"
        with torch.inference_mode(), (torch.cuda.device(self.device) if cuda
                                      else contextlib.nullcontext()):
            yield

    def _batches(self, images_u8: np.ndarray, fn):
        """``fn`` over padded device batches of ``images_u8``, enqueued back to back."""
        out = []
        with self._serving():
            for lo in range(0, len(images_u8), self.batch_size):
                raw = np.asarray(images_u8[lo:lo + self.batch_size])
                out.append(fn(self._put(_pad_chunk(raw, self._pad_target(len(raw))))))
        return out

    def _paths(self, paths, size_hw, num_workers, on_decode_error, fn, lagged):
        """``fn`` over decoded batches of ``paths`` (``_pipelined_batches``):
        ``(results, failed)``, results fetched one batch behind when
        ``lagged``."""
        def device_fn(imgs):
            with self._serving():
                return fn(self._put(imgs))

        if not lagged:
            return _pipelined_batches(paths, size_hw, self.batch_size, num_workers,
                                      device_fn, on_decode_error=on_decode_error,
                                      pad_target=self._pad_target)
        run, drain = _lagged_host_fetch(device_fn)
        _, failed = _pipelined_batches(paths, size_hw, self.batch_size, num_workers, run,
                                       on_decode_error=on_decode_error,
                                       pad_target=self._pad_target)
        return drain(), failed

    def _synthetic(self, size_hw) -> np.ndarray:
        rng = np.random.default_rng(0)
        return rng.integers(0, 256, (self.batch_size, *size_hw, 3), dtype=np.uint8)

    def _throughput(self, fn, size_hw, n_batches: int) -> float:
        """img/s of ``n_batches`` calls of ``fn`` (its last output is
        fetched) on a synthetic device-resident batch enqueued back to back,
        timed to the fetch of their outputs, after one warmup call."""
        with self._serving():
            imgs = self._put(self._synthetic(size_hw))
            fn(imgs).cpu()
            t0 = time.perf_counter()
            out = torch.cat([fn(imgs) for _ in range(n_batches)]).cpu().numpy()
        dt = time.perf_counter() - t0
        if not np.isfinite(out).all():
            raise RuntimeError("non-finite outputs in the throughput run")
        return self.batch_size * n_batches / dt

    def _latency_ms(self, fn, size_hw, n_iters: int) -> dict:
        imgs = self._synthetic(size_hw)

        def run_once():
            with self._serving():
                fn(self._put(imgs)).cpu()

        return _latency_stats_ms(run_once, n_iters)


class AnomalyScorer(_Engine):
    """Batched anomaly scorer over a score-only forward.

    Construct with :meth:`from_checkpoint` (a reference-layout ``.pth``),
    :meth:`from_state_dict` (in-process weights) or
    ``serve_artifact.load_artifact``.
    """

    def __init__(self, score_fn: Callable, image_size: int, batch_size: int,
                 device, quantize: Optional[str] = None, heatmap_fn=None,
                 bucket_sizes: Optional[Sequence[int]] = None, qparams=None,
                 export_state=None, devices: Optional[Sequence] = None):
        super().__init__(batch_size, device, bucket_sizes, export_state, devices)
        self._score_fn = score_fn
        self._heatmap_fn = heatmap_fn
        self.image_size = int(image_size)
        self.quantize = quantize  # 'int8' or None (float program)
        self.qparams = qparams  # the int8 tree, for save_qparams

    # -- constructors -------------------------------------------------------

    @classmethod
    def from_state_dict(cls, state_dict, *, image_size: int = 256,
                        batch_size: int = 128, precision: str = "bf16",
                        quantize: Optional[str] = None,
                        calib_images: Optional[np.ndarray] = None,
                        base_features: int = 64, bilinear: bool = False,
                        n_devices: Optional[int] = None,
                        qparams: Optional[dict] = None,
                        calib_percentile: Optional[float] = None,
                        with_heatmap: bool = False,
                        bucket_sizes: Optional[Sequence[int]] = None,
                        device="cuda", devices: Optional[Sequence] = None
                        ) -> "AnomalyScorer":
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
        ``n_devices`` (or ``devices``, e.g. ``("cuda:0", "cuda:1")``) holds
        one replica per device and splits each batch over them (module
        docstring); the calibration runs once, on the first.
        """
        if quantize not in (None, "none", "int8"):
            raise ValueError(f"unsupported quantize mode {quantize!r}")
        devices = _replica_devices(n_devices, devices, device)
        # fail before any model work
        _normalize_buckets(bucket_sizes, batch_size, len(devices))
        device = devices[0]
        if quantize == "int8" and qparams is None:
            if calib_images is None:
                raise ValueError("int8 quantization needs calib_images "
                                 "(a (N,H,W,3) uint8 array of in-domain "
                                 "images) or a precomputed qparams tree")
            qparams = quantize_from_train_state(
                "anomaly_unet", state_dict, chunk_calibration(calib_images, 16),
                percentile=calib_percentile, device=device)
        plans = {False: build_plan("anomaly_unet", score_only=True),
                 True: build_plan("anomaly_unet")} if quantize == "int8" else None

        def replica(dev):
            """(score_fn, heatmap_fn, export_state) on ``dev``."""
            if quantize == "int8":
                # keeps each leaf's constants across batches
                qexec = _QuantExec(tree_to(qparams, dev))
                export_state = (qexec.state, qexec.bound)

                def forward(img, with_amap):
                    with span("serve.forward"):
                        return _run(qexec, img, plans[with_amap])
            else:
                model = _float_model("anomaly_unet", state_dict, precision, True, dev,
                                     base_features=base_features, bilinear=bilinear)
                export_state = _module_state(model)

                def forward(img, with_amap):  # NHWC in and out; NCHW views inside
                    x = img.permute(0, 3, 1, 2)
                    with span("serve.forward"):
                        if not with_amap:
                            return model.score_forward(x).permute(0, 2, 3, 1)
                        return tuple(t.permute(0, 2, 3, 1) for t in model(x))

            def k1(images_u8):
                with span("serve.k1"):
                    return eval_transform(images_u8)

            def score_fn(images_u8):
                img = k1(images_u8)
                recon = forward(img, False)
                with span("serve.head"):
                    return anomaly_score(recon, img)

            def heatmap_fn(images_u8):
                img = k1(images_u8)
                recon, amap = forward(img, True)
                with span("serve.head"):
                    return anomaly_score(recon, img), _amap_to_u8(amap)

            return score_fn, heatmap_fn, export_state

        reps = [replica(d) for d in devices]
        return cls(_replicated([r[0] for r in reps], devices), image_size, batch_size,
                   device, quantize="int8" if quantize == "int8" else None,
                   heatmap_fn=(_replicated([r[1] for r in reps], devices)
                               if with_heatmap else None),
                   bucket_sizes=bucket_sizes,
                   qparams=tree_to(qparams, device) if quantize == "int8" else None,
                   export_state=reps[0][2], devices=devices)

    @classmethod
    def from_checkpoint(cls, checkpoint: str, **kwargs) -> "AnomalyScorer":
        """Load a reference-layout ``.pth`` (``tools/export_torch_checkpoint.py``
        writes one from a JAX checkpoint); keyword arguments as
        :meth:`from_state_dict`."""
        return cls.from_state_dict(load_reference_checkpoint(checkpoint), **kwargs)

    # -- scoring ------------------------------------------------------------

    def score_array(self, images_u8: np.ndarray) -> np.ndarray:
        """Score a (N, H, W, 3) uint8 array; returns (N,) float32 scores."""
        n = len(images_u8)
        if n == 0:
            return np.zeros((0,), np.float32)
        with span("serve.request"):
            pending = self._batches(images_u8, self._score_fn)
            with span("serve.fetch"):
                return torch.cat(pending).cpu().numpy()[:n]

    def score_paths(self, paths: Sequence[str], num_workers: int = 4,
                    on_decode_error: str = "raise", return_failed: bool = False):
        """Decode, resize and score image files; returns (N,) scores.

        A corrupt file raises :class:`DecodeError` naming the path; with
        ``on_decode_error='skip'`` it is logged and its score is NaN. With
        ``return_failed=True`` returns ``(scores, failed_indices)``.
        """
        hw = (self.image_size, self.image_size)
        with span("serve.request"):
            pending, failed = self._paths(paths, hw, num_workers, on_decode_error,
                                          self._score_fn, lagged=False)
            if not pending:
                scores = np.zeros((0,), np.float32)
                return (scores, []) if return_failed else scores
            with span("serve.fetch"):
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
                               "with with_heatmap=True (or export an artifact "
                               "from one)")

    def heatmap_array(self, images_u8: np.ndarray):
        """(N, H, W, 3) uint8 -> (scores (N,) f32, heatmaps (N, H, W) uint8)."""
        self._require_heatmap()
        n = len(images_u8)
        hw = self.image_size
        if n == 0:
            return np.zeros((0,), np.float32), np.zeros((0, hw, hw), np.uint8)
        with span("serve.request"):
            pending = self._batches(images_u8, self._heatmap_fn)
            with span("serve.fetch"):
                scores = torch.cat([s for s, _ in pending]).cpu().numpy()[:n]
                maps = torch.cat([m for _, m in pending]).cpu().numpy()[:n]
        return scores, maps

    def heatmap_paths(self, paths: Sequence[str], num_workers: int = 4,
                      on_decode_error: str = "raise", return_failed: bool = False):
        """Decode image files and produce (scores, heatmaps), with the decode
        pipeline and failure policy of :meth:`score_paths` (skipped files:
        score NaN, heatmap zero). Outputs come to the host one batch behind."""
        self._require_heatmap()
        hw = self.image_size
        with span("serve.request"):
            pending, failed = self._paths(paths, (hw, hw), num_workers, on_decode_error,
                                          self._heatmap_fn, lagged=True)
        if not pending:
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
        hw = self.image_size
        return self._throughput(self._score_fn, (hw, hw), n_batches)

    def latency_ms(self, n_iters: int = 50) -> dict:
        """Per-request latency (host uint8 -> host scores), ms: each iteration
        copies one serving batch to the device, scores it and fetches the
        scores. Build with ``batch_size=1`` for single-image latency. Returns
        {p50_ms, p95_ms, mean_ms}."""
        hw = self.image_size
        return self._latency_ms(self._score_fn, (hw, hw), n_iters)


class SegmentationPredictor(_Engine):
    """Batched mask-prediction engine for the segmentation workloads.

    The serving design of :class:`AnomalyScorer`, returning per-image class
    maps as uint8 and a per-image mean confidence (the largest softmax
    probability averaged over the image). Inputs may be non-square
    (KolektorSDD's 1024x512). Construct with :meth:`from_checkpoint`,
    :meth:`from_state_dict` or ``serve_artifact.load_artifact``.
    """

    def __init__(self, predict_fn: Callable, image_size_hw, batch_size: int, device,
                 num_classes: Optional[int] = None, quantize: Optional[str] = None,
                 bucket_sizes: Optional[Sequence[int]] = None, qparams=None,
                 export_state=None, devices: Optional[Sequence] = None, n_space: int = 1):
        super().__init__(batch_size, device, bucket_sizes, export_state, devices, n_space)
        self._predict_fn = predict_fn
        self.image_size_hw = tuple(int(x) for x in image_size_hw)
        self.num_classes = num_classes  # advisory (mask values encode classes)
        self.quantize = quantize  # 'int8' or None (float program)
        self.qparams = qparams  # the int8 tree, for save_qparams

    @classmethod
    def from_state_dict(cls, state_dict, *, num_classes: int,
                        image_size_hw=(512, 512), batch_size: int = 16,
                        precision: str = "bf16", quantize: Optional[str] = None,
                        calib_images: Optional[np.ndarray] = None,
                        base_features: int = 64, bilinear: bool = False,
                        dropout: float = 0.1, fold_bn: bool = True,
                        n_devices: Optional[int] = None, n_space: int = 1,
                        qparams: Optional[dict] = None,
                        calib_percentile: Optional[float] = None,
                        bucket_sizes: Optional[Sequence[int]] = None,
                        model_name: str = "seg_unet",
                        deep_supervision: bool = False, heads: int = 4,
                        tile_hw: Optional[Sequence[int]] = None,
                        tile_overlap: int = 64,
                        device="cuda", devices: Optional[Sequence] = None
                        ) -> "SegmentationPredictor":
        """Build a predictor from a segmentation model's state_dict
        (``model_name`` 'seg_unet', 'unetpp' or 'attn_unet'; ``bilinear``
        decoders).

        ``heads`` (UNet++ with ``deep_supervision`` only): 4 serves the
        average of the four heads; k < 4 the pruned fast mode, head X[0][k]
        alone, whose deeper grid columns never run. int8 calibrates the full
        grid (heads 4) on ``calib_images`` in chunks of 8, so saved qparams
        serve any ``heads``; ``qparams`` skips calibration.

        ``tile_hw`` serves images at native resolution: ``image_size_hw`` is
        then the full input extent and the model runs at ``tile_hw`` (its
        training shape) over a static grid of tiles overlapping by
        ``tile_overlap`` px, blended back (``ops/tiling.py``). ``n_devices``
        (or ``devices``) holds one replica per device and splits each batch
        over them, tiled or not (module docstring). ``n_space`` splits each
        replica's rows over that many devices (module docstring; the JAX
        package's refusals: not with ``tile_hw``, and ``n_space`` must
        divide the height: ``parallel/spatial.py::check_rows``).
        """
        if trains_only(model_name):
            raise ValueError(f"SegmentationPredictor does not serve {model_name}: it trains "
                             "through the segmentation train step alone")
        if quantize not in (None, "none", "int8"):
            raise ValueError(f"unsupported quantize mode {quantize!r}")
        if quantize == "int8" and model_name not in ("seg_unet", "unetpp", "attn_unet"):
            raise ValueError(
                f"int8 quantization is implemented for 'seg_unet', 'unetpp' "
                f"and 'attn_unet', not {model_name!r}; serve it in bf16/f32 "
                f"instead")
        if heads != 4 and not (model_name == "unetpp" and deep_supervision):
            raise ValueError(
                "heads selects a UNet++ deep-supervision inference head; it "
                f"requires model_name='unetpp' with deep_supervision (got "
                f"{model_name!r}, deep_supervision={deep_supervision})")
        if heads != 4:
            # Printed, not logged: the serve CLIs configure no logging handlers.
            print(f"unetpp pruned fast mode: serving the single head "
                  f"X[0][{heads}] (not a head average; deeper grid columns "
                  f"do not run)", flush=True)
        if n_space > 1:
            if tile_hw is not None:
                raise ValueError(
                    "tiled inference does not compose with --n_space spatial "
                    "sharding (the tile batch already fills the device; "
                    "shard it over 'data' with n_devices instead)")
            spatial.check_rows(image_size_hw[0], n_space)
        devices = _replica_devices(n_devices, devices, device, n_space)
        # fail before any model work
        _normalize_buckets(bucket_sizes, batch_size, len(devices) // n_space)
        device = devices[0]
        if quantize == "int8" and qparams is None:
            if calib_images is None:
                raise ValueError("int8 quantization needs calib_images "
                                 "or a precomputed qparams tree")
            qparams = quantize_from_train_state(
                model_name, state_dict, chunk_calibration(calib_images, 8),
                percentile=calib_percentile, device=device,
                deep_supervision=deep_supervision)
        plan = (build_plan(model_name, deep_supervision=deep_supervision, heads=heads)
                if quantize == "int8" else None)

        def replica(dev):
            """(predict_fn, export_state) on ``dev``."""
            if quantize == "int8":
                qexec = _QuantExec(tree_to(qparams, dev))
                export_state = (qexec.state, qexec.bound)

                def apply_logits(images_u8):
                    with span("serve.k1"):
                        img = eval_transform(images_u8)
                    with span("serve.forward"):
                        return _run(qexec, img, plan)
            else:
                model = _float_model(model_name, state_dict, precision, fold_bn, dev,
                                     n_classes=num_classes, bilinear=bilinear,
                                     dropout=dropout, base_features=base_features,
                                     deep_supervision=deep_supervision, heads=heads)
                export_state = _module_state(model)

                def apply_logits(images_u8):
                    with span("serve.k1"):
                        x = eval_transform(images_u8).permute(0, 3, 1, 2)
                    with span("serve.forward"):
                        return model(x).permute(0, 2, 3, 1)

            if tile_hw is not None:
                return make_tiled_logits_fn(apply_logits, image_size_hw, tile_hw,
                                            tile_overlap), export_state
            return apply_logits, export_state

        def predict(logits_fn):
            def predict_fn(images_u8):
                logits = logits_fn(images_u8)
                with span("serve.head"):
                    preds, conf = sliced_pred_confidence(logits)
                    return preds, conf.mean(dim=(1, 2))

            return predict_fn

        reps = [replica(d) for d in devices]
        fns = [r[0] for r in reps]
        if n_space > 1:  # each replica: its n_space devices' rows, then whole images
            fns = [_row_sharded(fns[i:i + n_space], devices[i:i + n_space])
                   for i in range(0, len(fns), n_space)]
        return cls(_replicated([predict(f) for f in fns], devices[::n_space]), image_size_hw,
                   batch_size, device, num_classes=num_classes,
                   quantize="int8" if quantize == "int8" else None,
                   bucket_sizes=bucket_sizes,
                   qparams=tree_to(qparams, device) if quantize == "int8" else None,
                   export_state=reps[0][1], devices=devices, n_space=n_space)

    @classmethod
    def from_checkpoint(cls, checkpoint: str, **kwargs) -> "SegmentationPredictor":
        """Load a ``.pth`` written by the seg trainers (or a reference-layout
        state_dict); keyword arguments as :meth:`from_state_dict`."""
        return cls.from_state_dict(load_reference_checkpoint(checkpoint), **kwargs)

    def _conf_fn(self, images):
        return self._predict_fn(images)[1]

    def predict_array(self, images_u8: np.ndarray):
        """(N, H, W, 3) uint8 -> (masks (N, H, W) uint8, mean_confidence (N,) f32)."""
        n = len(images_u8)
        h, w = self.image_size_hw
        if n == 0:
            return np.zeros((0, h, w), np.uint8), np.zeros((0,), np.float32)
        with span("serve.request"):
            pending = self._batches(images_u8, self._predict_fn)
            with span("serve.fetch"):
                masks = torch.cat([p for p, _ in pending]).cpu().numpy()[:n]
                confs = torch.cat([c for _, c in pending]).cpu().numpy()[:n]
        return masks, confs

    def warmup(self) -> None:
        """Run every serving shape once: each bucket, or the serving batch."""
        h, w = self.image_size_hw
        for b in (self.bucket_sizes or (self.batch_size,)):
            self.predict_array(np.zeros((b, h, w, 3), np.uint8))

    def throughput(self, n_batches: int = 10) -> float:
        """Mask-prediction throughput (img/s) on a synthetic device-resident
        batch, timed to the fetch of the (N,) confidences (which completes the
        masks too)."""
        return self._throughput(self._conf_fn, self.image_size_hw, n_batches)

    def latency_ms(self, n_iters: int = 50) -> dict:
        """Per-request latency (host uint8 -> prediction complete), ms: each
        iteration copies one serving batch to the device, predicts and
        fetches the confidences. Build with ``batch_size=1`` for single-image
        latency. Returns {p50_ms, p95_ms, mean_ms}."""
        return self._latency_ms(self._conf_fn, self.image_size_hw, n_iters)

    def predict_paths(self, paths: Sequence[str], num_workers: int = 4,
                      on_decode_error: str = "raise", return_failed: bool = False):
        """Decode and resize image files and predict, streaming batch by batch
        (decode overlaps device work; outputs come to the host one batch
        behind); returns (masks (N, H, W) uint8, mean_confidences (N,)).

        A corrupt file raises :class:`DecodeError` naming the path; with
        ``on_decode_error='skip'`` it is logged, its mask zeroed and its
        confidence NaN. With ``return_failed=True`` returns ``(masks, confs,
        failed_indices)``."""
        with span("serve.request"):
            pending, failed = self._paths(paths, self.image_size_hw, num_workers,
                                          on_decode_error, self._predict_fn, lagged=True)
        if not pending:
            h, w = self.image_size_hw
            masks = np.zeros((0, h, w), np.uint8)
            confs = np.zeros((0,), np.float32)
            return (masks, confs, []) if return_failed else (masks, confs)
        masks = np.concatenate([m for m, _ in pending])[:len(paths)]
        confs = np.concatenate([c for _, c in pending])[:len(paths)]
        if failed:
            masks, confs = masks.copy(), confs.copy()
            masks[np.asarray(failed)] = 0
            confs[np.asarray(failed)] = np.nan
        return (masks, confs, list(failed)) if return_failed else (masks, confs)
