"""Model analyzer CLI, the port of ``yolo_ms_tpu/tools/analyze.py``.

Per-stage parameter audit (weights from ``init_model`` with seed 0), the
forward FLOPs, per-stage feature shapes on a real or random image through
the built model's ``backbone``, ``neck`` and ``head``, the anchor check and
the staged pipeline == full model check (decoded outputs within 1e-5).

FLOPs come from ``torch.utils.flop_counter.FlopCounterMode``, whose
convention is 2 x multiply-accumulates of the convolutions and matrix
products only. XLA's cost model, which the JAX analyzer prints, also counts
elementwise work, so the two numbers are not comparable.

Usage:
  python -m yolo_ms_tpu_torch.tools.analyze --version n [--image path] [--all]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from yolo_ms_tpu_torch.models.decode import decode_predictions
from yolo_ms_tpu_torch.models.ms import YOLOMS, YOLOv8MS
from yolo_ms_tpu_torch.models.registry import MODEL_ZOO, build_model, count_params, init_model
from yolo_ms_tpu_torch.utils.device import full_f32, resolve_device

STAGES = ("backbone", "neck", "head")


def _family(version: str) -> str:
    cls, sub, kwargs = MODEL_ZOO[version.lower()]
    se = "*" if kwargs.get("use_se") else ""
    if cls is YOLOMS:
        return f"YOLO-MS-{sub.upper()}{se}"
    if cls is YOLOv8MS:
        return f"YOLOv8-MS-{sub.upper()}{se}"
    return f"YOLOv8-{sub.upper()}"


def _nhwc(maps):
    return [m.permute(0, 2, 3, 1) for m in maps]


def _stats(f: torch.Tensor) -> str:
    return f"mean={float(f.mean()):+.4f} std={float(f.std()):.4f}"


def analyze(
    version: str,
    image_path: str | None = None,
    num_classes: int = 80,
    img_size: int = 640,
    device=None,
) -> dict:
    """Print the analysis; return ``params``, ``stage_params``, ``flops``
    (per image), ``anchors``, ``expected_anchors`` and ``decoded``."""
    if version.lower() not in MODEL_ZOO:
        raise ValueError(f"Unknown architecture '{version}'. Available: {sorted(MODEL_ZOO)}")
    dev = resolve_device(device)
    print(f"\n{'=' * 60}\n{_family(version)} analysis\n{'=' * 60}")
    model = build_model(version, num_classes=num_classes, device="cpu")
    init_model(model, torch.Generator().manual_seed(0))
    model.to(dev)
    total = count_params(model)
    print(f"Total parameters: {total / 1e6:.2f} million ({total:,})")
    stage_params = {s: count_params(getattr(model, s)) for s in STAGES}

    if image_path:
        from yolo_ms_tpu_torch.data.decode import decode_and_resize

        img = decode_and_resize(image_path, img_size, img_size)
        x = torch.from_numpy(img[None]).float() / 255.0
        print(f"Input image: {image_path}")
    else:
        rng = np.random.default_rng(1)
        x = torch.from_numpy(rng.standard_normal((1, img_size, img_size, 3), np.float32))
        print(f"Input: random normal [1, {img_size}, {img_size}, 3] (numpy seed 1)")
    x = x.permute(0, 3, 1, 2).contiguous().to(dev)  # NCHW inside the network

    from torch.utils.flop_counter import FlopCounterMode

    with torch.inference_mode(), full_f32():
        counter = FlopCounterMode(display=False)
        with counter:
            model(x)
        flops = counter.get_total_flops()
        print(f"Forward FLOPs (FlopCounterMode, 2 x MACs of convs and matmuls, "
              f"{img_size}x{img_size}): {flops / 1e9:.2f} G/image")
        for s in STAGES:
            print(f"  {s:10s}: {stage_params[s] / 1e6:.3f}M params")

        p3, p4, p5 = model.backbone(x)
        print("Backbone outputs (NCHW):")
        for name, f in zip(("P3", "P4", "P5"), (p3, p4, p5)):
            print(f"  {name}: {tuple(f.shape)}  {_stats(f)}")
        n1, n2, n3 = model.neck(p3, p4, p5)
        print("Neck outputs (NCHW):")
        for name, f in zip(("N1", "N2", "N3"), (n1, n2, n3)):
            print(f"  {name}: {tuple(f.shape)}  {_stats(f)}")
        raw = model.head((n1, n2, n3))
        print("Head raw maps (training-mode output, NCHW):")
        anchors = 0
        for i, r in enumerate(raw):
            n = r.shape[2] * r.shape[3]
            anchors += n
            print(f"  P{i + 3}: {tuple(r.shape)} - {n:,} anchors - {8 * 2**i}x downsampled")
        print(f"  Total anchors: {anchors:,}")

        decoded = decode_predictions(_nhwc(raw), num_classes)
        print(f"Decoded eval output: {tuple(decoded.shape)} "
              f"[batch, anchors, 4 box + {num_classes} classes]")
        expected = sum((img_size // s) ** 2 for s in (8, 16, 32))
        status = "OK" if decoded.shape[1] == expected else "MISMATCH"
        print(f"Anchor check: {decoded.shape[1]:,} == {expected:,} expected -> {status}")

        # consistency: staged pipeline == full model (test_model.py:276)
        full = decode_predictions(_nhwc(model(x)), num_classes)
        ok = bool(torch.allclose(full, decoded, atol=1e-5))
    print(f"Full model == staged pipeline: {'OK' if ok else 'FAILED'}")
    if not ok:
        raise AssertionError("staged pipeline diverges from full model")
    return {
        "params": total,
        "stage_params": stage_params,
        "flops": flops,
        "anchors": int(decoded.shape[1]),
        "expected_anchors": expected,
        "decoded": decoded,
    }


def main(argv: list[str] | None = None) -> None:
    parser = argparse.ArgumentParser(description="Analyze detector structure.")
    parser.add_argument("--version", type=str, default="n")
    parser.add_argument("--image", type=str, default=None)
    parser.add_argument("--num_classes", type=int, default=80)
    parser.add_argument("--img_size", type=int, default=640)
    parser.add_argument("--device", type=str, default=None, help="default: the card")
    parser.add_argument(
        "--all", action="store_true", help="Analyze every YOLOv8 version (main.py:76-86)."
    )
    args = parser.parse_args(argv)
    versions = ["n", "s", "m", "l", "x"] if args.all else [args.version]
    for v in versions:
        analyze(v, args.image, args.num_classes, args.img_size, device=args.device)


if __name__ == "__main__":
    main()
