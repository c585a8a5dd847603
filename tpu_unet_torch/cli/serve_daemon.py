#!/usr/bin/env python3
"""Online HTTP serving daemon CLI (counterpart of
``tpu_unet/cli/serve_daemon.py``; ``serve_http.py``).

Builds a serving engine from a ``.pth`` (BN folded, optional int8) or loads
an exported artifact, runs every serving shape once, and serves
single-image requests over HTTP with micro-batching (concurrent requests
share one padded engine call per window). One daemon serves one device:
run one per card behind a load balancer to scale out.

Examples:
  python -m tpu_unet_torch.cli.serve_daemon --task anomaly \
      --checkpoint best_model.pth --port 8000 --batch_size 8 --threshold 0.012
  python -m tpu_unet_torch.cli.serve_daemon --artifact artifact_dir/ --port 8000
  curl -s --data-binary @img.png localhost:8000/v1/score
"""

from __future__ import annotations

import argparse

from tpu_unet_torch.cli._artifact_common import (add_artifact_args, add_bucket_arg,
                                                  load_artifact_engine, parse_bucket_sizes,
                                                  validate_artifact_args)
from tpu_unet_torch.cli._quant_common import maybe_save_qparams, resolve_quantization


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="Online HTTP serving daemon (micro-batched)")
    p.add_argument("--task", type=str, default=None,
                   choices=["anomaly", "seg"],
                   help="Engine kind; required with --checkpoint "
                        "(--artifact carries it in meta.json)")
    p.add_argument("--checkpoint", type=str, default=None)
    add_artifact_args(p)
    p.add_argument("--host", type=str, default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max_wait_ms", type=float, default=5.0,
                   help="Micro-batch window: how long the first request of a "
                        "batch waits for followers")
    p.add_argument("--max_queue", type=int, default=0,
                   help="Overload bound: max requests waiting for a batch "
                        "slot; beyond it requests get 503 + Retry-After "
                        "(0 = unbounded)")
    p.add_argument("--request_timeout_s", type=float, default=120.0,
                   help="Per-request server-side timeout; a request still "
                        "queued past it is dropped without an engine call")
    p.add_argument("--threshold", type=float, default=None,
                   help="anomaly only: adds an 'anomalous' verdict per response")
    p.add_argument("--heatmap", action="store_true",
                   help="anomaly only: also build the heatmap program and "
                        "serve POST /v1/heatmap (score + anomaly-map PNG)")
    p.add_argument("--image_size", type=int, default=256, help="anomaly only")
    p.add_argument("--image_height", type=int, default=512, help="seg only")
    p.add_argument("--image_width", type=int, default=512, help="seg only")
    p.add_argument("--num_classes", type=int, default=4, help="seg only")
    p.add_argument("--model", type=str, default="seg_unet",
                   choices=["seg_unet", "unetpp", "attn_unet"],
                   help="seg only: architecture the checkpoint was trained with")
    p.add_argument("--deep_supervision", action="store_true",
                   help="seg unetpp only: checkpoint was trained with "
                        "--deep_supervision")
    p.add_argument("--heads", type=int, default=4,
                   help="seg unetpp deep-supervision inference mode: 4 = "
                        "averaged accurate mode; k<4 = pruned fast mode "
                        "(the single head X[0][k])")
    p.add_argument("--batch_size", type=int, default=8,
                   help="Max micro-batch (the engine's serving batch)")
    add_bucket_arg(p)
    p.add_argument("--precision", type=str, default="bf16", choices=["bf16", "f32"])
    p.add_argument("--quantize", type=str, default="none", choices=["none", "int8"])
    p.add_argument("--calib_dir", type=str, default=None)
    p.add_argument("--calib_samples", type=int, default=64)
    p.add_argument("--calib_percentile", type=float, default=None)
    p.add_argument("--qparams", type=str, default=None,
                   help="Quantized-params .npz: loaded if it exists, else "
                        "written after calibrating")
    p.add_argument("--base_features", type=int, default=64)
    p.add_argument("--bilinear", action="store_true")
    p.add_argument("--device", type=str, default="cuda", choices=["cuda", "cpu"])
    return p.parse_args(argv), p


def build_service(args, parser):
    """Engine and ServingService from the parsed flags (no socket)."""
    from tpu_unet_torch.serve_http import ServingService

    validate_artifact_args(
        args, parser, sharded=False, sharded_flags="",
        baked_flags=("task", "image_size", "image_height", "image_width",
                     "num_classes", "batch_size", "precision", "quantize",
                     "calib_dir", "calib_samples", "calib_percentile",
                     "qparams", "base_features", "bilinear", "heatmap",
                     "bucket_sizes", "model", "deep_supervision", "heads"))
    if args.artifact:
        engine = load_artifact_engine(args)
    else:
        if args.task is None:
            raise SystemExit("--task anomaly|seg is required with --checkpoint")
        if args.heatmap and args.task != "anomaly":
            raise SystemExit("--heatmap only applies to --task anomaly")
        if args.task != "seg" and (args.model != "seg_unet" or args.deep_supervision
                                   or args.heads != 4):
            raise SystemExit("--model/--deep_supervision/--heads only apply "
                             "to --task seg")
        buckets = parse_bucket_sizes(args, args.batch_size)
        if args.task == "anomaly":
            size_hw = (args.image_size, args.image_size)
        else:
            size_hw = (args.image_height, args.image_width)
        quantize, calib_images, qparams_tree = resolve_quantization(args, size_hw)
        common = dict(batch_size=args.batch_size, precision=args.precision,
                      quantize=quantize, calib_images=calib_images,
                      base_features=args.base_features, bilinear=args.bilinear,
                      qparams=qparams_tree, calib_percentile=args.calib_percentile,
                      bucket_sizes=buckets, device=args.device)
        if args.task == "anomaly":
            from tpu_unet_torch.serve import AnomalyScorer
            engine = AnomalyScorer.from_checkpoint(
                args.checkpoint, image_size=args.image_size, with_heatmap=args.heatmap,
                **common)
        else:
            from tpu_unet_torch.serve import SegmentationPredictor
            engine = SegmentationPredictor.from_checkpoint(
                args.checkpoint, num_classes=args.num_classes, image_size_hw=size_hw,
                model_name=args.model, deep_supervision=args.deep_supervision,
                heads=args.heads, **common)
        maybe_save_qparams(args, engine, qparams_tree)
    if args.max_queue < 0:
        raise SystemExit("--max_queue must be >= 0 (0 = unbounded)")
    if args.request_timeout_s <= 0:
        raise SystemExit("--request_timeout_s must be positive")
    return ServingService(engine, max_wait_ms=args.max_wait_ms,
                          threshold=args.threshold,
                          request_timeout_s=args.request_timeout_s,
                          max_queue=args.max_queue or None)


def serve_until_signal(server, service) -> None:
    """serve_forever until SIGTERM or Ctrl-C, then shut down cleanly: the
    SIGTERM handler raises SystemExit in the serving thread, the threaded
    HTTP server waits for in-flight handlers on close, and the
    micro-batchers serve what they queued before the engine goes away."""
    import signal

    def _term(signum, frame):
        raise SystemExit(0)

    prev = signal.signal(signal.SIGTERM, _term)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        print("Shutting down (SIGINT)")
    except SystemExit:
        print("Shutting down (SIGTERM)")
    finally:
        signal.signal(signal.SIGTERM, prev)
        server.server_close()
        service.close()


def main(argv=None):
    args, parser = parse_args(argv)
    from tpu_unet_torch.serve_http import make_server
    service = build_service(args, parser)
    print("Warming up (every serving shape once)...")
    service.warmup()
    server = make_server(service, host=args.host, port=args.port)
    host, port = server.server_address[:2]
    endpoint = "/v1/score" if service.kind == "anomaly_scorer" else "/v1/predict"
    if service.heatmap_batcher is not None:
        endpoint += " + /v1/heatmap"
    buckets = ("" if not service.engine.bucket_sizes else
               f", buckets {list(service.engine.bucket_sizes)}")
    bound = (f", queue bound {service.batcher.max_queue}"
             if service.batcher.max_queue else "")
    print(f"Serving {service.kind} on http://{host}:{port}{endpoint} "
          f"(batch {service.engine.batch_size} @ {service.size_hw}{buckets}, "
          f"window {args.max_wait_ms} ms{bound}; GET /healthz for stats)", flush=True)
    serve_until_signal(server, service)


if __name__ == "__main__":
    main()
