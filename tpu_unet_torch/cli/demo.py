#!/usr/bin/env python3
"""Environment smoke test (counterpart of ``tpu_unet/cli/demo.py``): dataset
load -> one loader batch -> UNet and AnomalyUNet forward shapes -> sample
panel PNG. Generates a tiny synthetic category when no dataset is given.
Runs on ``cuda`` unless ``--device cpu``."""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np
import torch


def parse_args(argv=None):
    parser = argparse.ArgumentParser(description="tpu_unet_torch environment smoke test")
    parser.add_argument("--data_root", type=str, default=None,
                        help="MVTec root (default: generate a tiny synthetic set)")
    parser.add_argument("--category", type=str, default="bottle")
    parser.add_argument("--image_size", type=int, default=64)
    parser.add_argument("--output", type=str, default="demo_samples.png")
    parser.add_argument("--device", type=str, default="cuda", choices=["auto", "cuda", "cpu"])
    return parser.parse_args(argv)


def _make_synthetic(root, category, size):
    from PIL import Image
    rng = np.random.default_rng(0)
    for sub in (f"{category}/train/good", f"{category}/test/good",
                f"{category}/test/scratch", f"{category}/ground_truth/scratch"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i in range(4):
        img = rng.integers(0, 255, (size, size, 3), dtype=np.uint8)
        Image.fromarray(img).save(os.path.join(root, category, "train/good", f"{i}.png"))
        Image.fromarray(img).save(os.path.join(root, category, "test/good", f"{i}.png"))
        Image.fromarray(img).save(os.path.join(root, category, "test/scratch", f"{i}.png"))
        m = np.zeros((size, size), np.uint8)
        m[8:16, 8:16] = 255
        Image.fromarray(m).save(
            os.path.join(root, category, "ground_truth/scratch", f"{i}_mask.png"))
    return root


def main(argv=None):
    args = parse_args(argv)
    from tpu_unet_torch.cli.train_mvtec import cli_device
    from tpu_unet_torch.data.loader import DataLoader, to_device
    from tpu_unet_torch.data.mvtec import MVTecDataset
    from tpu_unet_torch.models import AnomalyUNet, UNet
    from tpu_unet_torch.ops.augment import eval_transform
    from tpu_unet_torch.utils.viz import visualize_results

    device = cli_device(args.device)
    print(f"PyTorch {torch.__version__}; device: {device}")

    root = args.data_root
    if root is None:
        root = _make_synthetic(tempfile.mkdtemp(prefix="tpu_unet_torch_demo_"),
                               args.category, args.image_size)
        print(f"Using synthetic dataset at {root}")

    ds = MVTecDataset(root, args.category, "test", args.image_size, is_train=False)
    print(f"Dataset: {len(ds)} test samples")
    loader = DataLoader(ds, batch_size=4, pad_last=True, num_workers=2)
    batch = next(iter(loader))
    print(f"Batch image {batch['image'].shape} {batch['image'].dtype}, "
          f"mask {batch['mask'].shape}")

    dev_batch = to_device(batch, device)
    torch.manual_seed(0)
    with torch.no_grad():
        x = eval_transform(dev_batch["image"])  # NHWC float32
        xc = x.permute(0, 3, 1, 2)
        model = UNet(n_classes=1, base_features=8).to(device).eval()
        logits = model(xc)
        print(f"UNet forward: {tuple(xc.shape)} -> {tuple(logits.shape)}")
        amodel = AnomalyUNet(base_features=8).to(device).eval()
        recon, amap = amodel(xc)
        print(f"AnomalyUNet forward: recon {tuple(recon.shape)}, "
              f"anomaly_map {tuple(amap.shape)}")

    visualize_results(x.cpu().numpy(), batch["mask"][..., 0],
                      amap[:, 0].cpu().numpy(), recon.permute(0, 2, 3, 1).cpu().numpy(),
                      save_path=args.output, max_samples=4)
    print("Demo completed successfully!")
    return True


if __name__ == "__main__":
    main()
