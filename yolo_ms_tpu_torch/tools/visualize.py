"""Feature-map visualization, the port of ``yolo_ms_tpu/tools/visualize.py``.

Renders per-stage feature-map grids (backbone P3/P4/P5, neck N1/N2/N3),
head prediction histograms and the decoded confidence distribution to the
same six PNG files as the JAX module. Weights come from ``init_model`` with
seed 0; without an image the input is uniform noise from a seeded numpy
``Generator`` (the JAX module draws it from its own PRNG, so the pictures
differ by design). ``matplotlib`` is imported only when this runs.

Usage:
  python -m yolo_ms_tpu_torch.tools.visualize --version n --image path.jpg \\
      --out runs/viz
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from yolo_ms_tpu_torch.models.decode import decode_predictions
from yolo_ms_tpu_torch.models.registry import build_model, init_model
from yolo_ms_tpu_torch.utils.device import full_f32, resolve_device


def visualize(
    version: str,
    image_path: str | None,
    out_dir: str,
    num_classes: int = 80,
    channels_per_stage: int = 16,
    img_size: int = 640,
    device=None,
) -> str:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    model = build_model(version, num_classes=num_classes, device="cpu")
    init_model(model, torch.Generator().manual_seed(0))
    model.to(dev)

    if image_path:
        from yolo_ms_tpu_torch.data.decode import decode_and_resize

        raw_img = decode_and_resize(image_path, img_size, img_size)
        x = torch.from_numpy(raw_img[None]).float() / 255.0
    else:
        x = torch.from_numpy(
            np.random.default_rng(1).random((1, img_size, img_size, 3), np.float32)
        )
    x = x.permute(0, 3, 1, 2).contiguous().to(dev)

    def grid_figure(feat, title, path):
        f = feat[0].float().cpu().numpy()  # [C, H, W]
        c = min(channels_per_stage, f.shape[0])
        cols = 4
        rows = (c + cols - 1) // cols
        fig, axes = plt.subplots(rows, cols, figsize=(3 * cols, 3 * rows))
        for i in range(rows * cols):
            ax = axes.flat[i]
            ax.axis("off")
            if i < c:
                ax.imshow(f[i], cmap="viridis")
                ax.set_title(f"ch {i}", fontsize=8)
        fig.suptitle(title)
        fig.tight_layout()
        fig.savefig(path, dpi=80)
        plt.close(fig)

    with torch.inference_mode(), full_f32():
        p3, p4, p5 = model.backbone(x)
        n1, n2, n3 = model.neck(p3, p4, p5)
        raw = [m.permute(0, 2, 3, 1) for m in model(x)]  # NHWC, as the JAX maps
        decoded = decode_predictions(raw, num_classes)

    for name, f in (("P3", p3), ("P4", p4), ("P5", p5)):
        grid_figure(f, f"Backbone {name} {tuple(f.shape)} (NCHW)",
                    os.path.join(out_dir, f"backbone_{name}.png"))
    for name, f in (("N1", n1), ("N2", n2), ("N3", n3)):
        grid_figure(f, f"Neck {name} {tuple(f.shape)} (NCHW)",
                    os.path.join(out_dir, f"neck_{name}.png"))

    fig, axes = plt.subplots(1, 3, figsize=(15, 4))
    for i, r in enumerate(raw):
        axes[i].hist(r.float().cpu().numpy().ravel(), bins=80)
        axes[i].set_title(f"P{i + 3} raw logits {tuple(r.shape)}")
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "head_histograms.png"), dpi=80)
    plt.close(fig)

    conf = decoded[0, :, 4:].max(-1).values.cpu().numpy()
    fig, ax = plt.subplots(figsize=(6, 4))
    ax.hist(conf, bins=80)
    ax.set_title("max class confidence per anchor")
    ax.set_xlabel("sigmoid score")
    fig.tight_layout()
    fig.savefig(os.path.join(out_dir, "confidence_distribution.png"), dpi=80)
    plt.close(fig)

    print(f"Wrote visualizations to {out_dir}/")
    return out_dir


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="Visualize per-stage feature maps.")
    parser.add_argument("--version", type=str, default="n")
    parser.add_argument("--image", type=str, default=None)
    parser.add_argument("--out", type=str, default="runs/viz")
    parser.add_argument("--num_classes", type=int, default=80)
    parser.add_argument("--img_size", type=int, default=640)
    parser.add_argument("--device", type=str, default=None, help="default: the card")
    args = parser.parse_args(argv)
    visualize(
        args.version, args.image, args.out, args.num_classes,
        img_size=args.img_size, device=args.device,
    )


if __name__ == "__main__":
    main()
