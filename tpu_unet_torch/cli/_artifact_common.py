"""Shared --artifact / --export_artifact / --bucket_sizes wiring for the serve
CLIs (counterpart of ``tpu_unet/cli/_artifact_common.py``)."""

from __future__ import annotations

from tpu_unet_torch.serve import _normalize_buckets


def add_artifact_args(p) -> None:
    p.add_argument("--artifact", type=str, default=None,
                   help="Serve from an exported artifact directory "
                        "(tpu_unet_torch.serve_artifact) instead of --checkpoint; "
                        "batch and image geometry come from the artifact")
    p.add_argument("--export_artifact", type=str, default=None,
                   help="After building the engine from --checkpoint, export "
                        "it as a self-contained serving artifact to this dir")
    p.add_argument("--artifact_platforms", type=str, default=None,
                   help="Comma-separated platforms for --export_artifact; a "
                        "torch.export program serves the device it was "
                        "exported on, so only that device type (--device) is "
                        "accepted")


def add_bucket_arg(p) -> None:
    p.add_argument("--bucket_sizes", type=str, default=None,
                   help="Comma-separated batch-shape ladder (e.g. '1,2,4'): "
                        "a ragged batch pads to the smallest adequate bucket "
                        "instead of the full --batch_size (always the top "
                        "bucket). Exported artifacts hold one program per "
                        "bucket over one copy of the weights")


def parse_bucket_sizes(args, batch_size=None):
    """--bucket_sizes string -> list of ints (None when unset), SystemExit on
    a malformed ladder; ``batch_size`` also range-checks it before any engine
    or calibration work."""
    if not getattr(args, "bucket_sizes", None):
        return None
    try:
        buckets = [int(tok) for tok in args.bucket_sizes.split(",") if tok]
    except ValueError:
        raise SystemExit(f"--bucket_sizes must be comma-separated integers, "
                         f"got {args.bucket_sizes!r}")
    if batch_size is not None:
        try:
            _normalize_buckets(buckets, batch_size)
        except ValueError as e:
            raise SystemExit(f"--bucket_sizes: {e}")
    return buckets


def validate_artifact_args(args, parser, sharded: bool, sharded_flags: str,
                           baked_flags: tuple = ()) -> None:
    """SystemExit on contradictory flags, before any model work.

    ``sharded``: a flag value asks for more than one device.
    ``baked_flags``: engine-construction flags whose values an artifact
    fixed at export; a value other than the default beside --artifact is
    refused, since it would have no effect. --artifact_platforms must name
    the --device type.
    """
    if bool(args.artifact) == bool(args.checkpoint):
        raise SystemExit("exactly one of --checkpoint or --artifact is required")
    if args.artifact and args.export_artifact:
        raise SystemExit("--export_artifact requires --checkpoint (an artifact "
                         "is already the exported form)")
    if sharded and (args.artifact or args.export_artifact):
        which = "--artifact" if args.artifact else "--export_artifact"
        raise SystemExit(f"{sharded_flags} do not apply to {which} "
                         "(artifacts are per-device programs)")
    if args.artifact:
        baked = [f"--{name}" for name in baked_flags
                 if getattr(args, name) != parser.get_default(name)]
        if baked:
            raise SystemExit("fixed by the artifact at export (batch and image "
                             "geometry, precision, quantization, model): "
                             + ", ".join(baked) + " cannot be set with --artifact")
    if args.artifact_platforms is not None:
        if {p for p in args.artifact_platforms.split(",") if p} != {args.device}:
            raise SystemExit(f"--artifact_platforms {args.artifact_platforms!r}: a "
                             f"torch.export program serves the device it was exported "
                             f"on; only {args.device!r} (--device) is accepted")


def load_artifact_engine(args):
    from tpu_unet_torch.serve_artifact import load_artifact
    engine = load_artifact(args.artifact, device=args.device)
    geometry = getattr(engine, "image_size", None) or engine.image_size_hw
    print(f"Loaded serving artifact {args.artifact} "
          f"(batch {engine.batch_size} @ {geometry})")
    return engine


def maybe_export_artifact(engine, args) -> None:
    if not args.export_artifact:
        return
    from tpu_unet_torch.serve_artifact import export_artifact
    plats = (args.artifact_platforms.split(",") if args.artifact_platforms else None)
    meta = export_artifact(engine, args.export_artifact, platforms=plats)
    print(f"Serving artifact exported to {args.export_artifact} "
          f"(device {meta['device']})")
