"""Typed config system — YAML schema 1:1 with the reference.

A copy of ``yolo_ms_tpu/utils/config.py`` for the port. Two changes: PyYAML
is imported only where a YAML file is read, so ``Config.from_dict``, JSON
configs and ``Config.save`` (which writes JSON) work without it, and
``device`` defaults to ``"cuda"`` (only ``"cpu"`` asks the port's entry
points for the CPU; any other value means the card).

The reference loads a raw YAML dict (utils.py:5-9) and scatters `.get()`
defaults across call sites; here the same schema (coco_yolov8.yaml:1-85,
finetune_example.yaml:1-78) maps onto typed dataclasses with defaults in one
place. `load_config(path)` accepts any reference config file unchanged.

Sections: dataset / model / training (incl. scheduler + augmentation) /
evaluation / testing / loss / device / workers.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field


def _build(cls, data: dict | None):
    data = dict(data or {})
    names = {f.name for f in dataclasses.fields(cls)}
    known = {k: v for k, v in data.items() if k in names}
    extra = {k: v for k, v in data.items() if k not in names}
    obj = cls(**known)
    if hasattr(obj, "extra"):
        obj.extra = extra
    return obj


@dataclass
class DatasetConfig:
    train_images_path: str = ""
    train_annotations_path: str = ""
    val_images_path: str = ""
    val_annotations_path: str = ""
    num_classes: int = 80
    class_names: list[str] = field(default_factory=list)
    max_gt: int = 128  # padded GT capacity per image (static shapes)
    # GT shape buckets: per batch the trainer slices the padded GT tensors
    # to the smallest bucket covering every valid slot (exact — padding is
    # fully masked; see Trainer._bucket_gt). Cuts the TAL assigner's
    # [B, max_gt, A] HBM traffic ~4x on typical data. [] disables.
    gt_buckets: list[int] = field(default_factory=lambda: [32, 64])
    extra: dict = field(default_factory=dict)

    def resolved_class_names(self) -> list[str]:
        if self.class_names:
            return list(self.class_names)
        if self.num_classes == 80:
            from yolo_ms_tpu_torch.data.coco_classes import COCO_CLASSES

            return list(COCO_CLASSES)
        return [f"class_{i}" for i in range(self.num_classes)]


@dataclass
class ModelConfig:
    architecture: str = "n"
    input_size: list[int] = field(default_factory=lambda: [640, 640])
    pretrained_weights_path: str | None = None
    reg_max: int = 16
    compute_dtype: str = "float32"  # or "bfloat16" (autocast on the card)
    extra: dict = field(default_factory=dict)


@dataclass
class SchedulerConfig:
    type: str = "cosine"  # cosine | step | none
    step_lr_size: int = 30
    step_lr_gamma: float = 0.1
    cosine_t_max: int | None = None
    cosine_eta_min: float = 1e-5
    warmup_steps: int = 0
    extra: dict = field(default_factory=dict)


@dataclass
class AugmentationConfig:
    hsv_h: float = 0.0
    hsv_s: float = 0.0
    hsv_v: float = 0.0
    degrees: float = 0.0
    translate: float = 0.0
    scale: float = 0.0
    shear: float = 0.0
    perspective: float = 0.0
    flipud: float = 0.0
    fliplr: float = 0.0
    mosaic: float = 0.0
    mixup: float = 0.0
    extra: dict = field(default_factory=dict)

    def as_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d.pop("extra", None)
        return d


@dataclass
class TrainingConfig:
    batch_size: int = 16
    learning_rate: float = 1e-3
    optimizer: str = "adam"  # adam | sgd
    adam_betas: list[float] = field(default_factory=lambda: [0.9, 0.999])
    sgd_momentum: float = 0.937
    sgd_nesterov: bool = True
    weight_decay: float = 5e-4
    epochs: int = 100
    val_interval: int = 1
    experiment_name: str = "exp"
    scheduler: SchedulerConfig = field(default_factory=SchedulerConfig)
    checkpoint_dir: str = ""
    save_period: int = 10
    log_dir: str = "runs/train"
    seed: int = 42
    pretrained_weights: str | None = None
    freeze_layers: list[str] = field(default_factory=list)
    augmentation: AugmentationConfig = field(default_factory=AugmentationConfig)
    grad_clip_norm: float = 0.0  # 0 disables
    ema_decay: float = 0.0  # e.g. 0.9999; 0 disables weight EMA
    # Gradient accumulation: apply the optimizer every k train steps on the
    # mean of the k micro-batch gradients (effective batch = k*batch_size
    # when a batch doesn't fit HBM). 0/1 disables.
    grad_accum_steps: int = 1
    # Multi-scale training: square input sizes (stride-32 multiples) sampled
    # per block of multiscale_interval batches, deterministic in
    # (seed, epoch, block) so every host picks the same size and resume is
    # exact. One jit specialization per size. Empty disables (fixed
    # model.input_size).
    multiscale_sizes: list[int] = field(default_factory=list)
    multiscale_interval: int = 10
    extra: dict = field(default_factory=dict)


@dataclass
class EvaluationConfig:
    batch_size: int = 32
    img_size: list[int] = field(default_factory=lambda: [640, 640])
    iou_threshold: float = 0.5
    confidence_threshold: float = 0.25
    # mAP IoU thresholds: [0.5] (reference parity, train.py:41-47) or the
    # string "coco" for the COCO-standard 0.50:0.05:0.95 AP. With multiple
    # thresholds the validator still selects/returns mAP@0.5 (best-model
    # criterion parity) and logs the averaged AP alongside.
    map_iou_thresholds: list[float] | str = field(default_factory=lambda: [0.5])
    extra: dict = field(default_factory=dict)


@dataclass
class TestingConfig:
    img_size: list[int] = field(default_factory=lambda: [640, 640])
    iou_threshold: float = 0.5
    confidence_threshold: float = 0.25
    source: str = ""
    save_predictions: bool = True
    output_dir: str = "runs/detect/exp"
    extra: dict = field(default_factory=dict)


@dataclass
class LossConfig:
    alpha: float = 0.25
    gamma: float = 1.5
    box_weight: float = 7.5
    cls_weight: float = 0.5
    dfl_weight: float = 1.5
    use_focal: bool = False
    tal_topk: int = 10
    iou_type: str = "ciou"  # iou | giou | diou | ciou (reference loss.py:95,118)
    extra: dict = field(default_factory=dict)


@dataclass
class ParallelConfig:
    """Mesh layout. spatial > 1 trains over a 2-D (data, spatial) mesh:
    batch over 'data', image height over 'spatial' — hybrid DP x SP for
    high-resolution inputs where per-chip activation memory binds
    (parallel/mesh.py:make_mesh_2d; equivalence vs pure DP tested in
    tests/test_spatial_sharding.py). Device count must be divisible by
    spatial; image height must be divisible by spatial."""

    spatial: int = 1
    extra: dict = field(default_factory=dict)


@dataclass
class Config:
    dataset: DatasetConfig = field(default_factory=DatasetConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    training: TrainingConfig = field(default_factory=TrainingConfig)
    evaluation: EvaluationConfig = field(default_factory=EvaluationConfig)
    testing: TestingConfig = field(default_factory=TestingConfig)
    loss: LossConfig = field(default_factory=LossConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    device: str = "cuda"
    workers: int = 4
    extra: dict = field(default_factory=dict)

    @classmethod
    def from_dict(cls, d: dict) -> "Config":
        d = dict(d or {})
        training = dict(d.get("training") or {})
        sched = _build(SchedulerConfig, training.pop("scheduler", None))
        aug = _build(AugmentationConfig, training.pop("augmentation", None))
        tc = _build(TrainingConfig, training)
        tc.scheduler = sched
        tc.augmentation = aug
        cfg = cls(
            dataset=_build(DatasetConfig, d.get("dataset")),
            model=_build(ModelConfig, d.get("model")),
            training=tc,
            evaluation=_build(EvaluationConfig, d.get("evaluation")),
            testing=_build(TestingConfig, d.get("testing")),
            loss=_build(LossConfig, d.get("loss")),
            parallel=_build(ParallelConfig, d.get("parallel")),
            device=d.get("device", "cuda"),
            workers=d.get("workers", 4),
        )
        cfg.extra = {
            k: v
            for k, v in d.items()
            if k
            not in (
                "dataset",
                "model",
                "training",
                "evaluation",
                "testing",
                "loss",
                "parallel",
                "device",
                "workers",
            )
        }
        return cfg

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        for sect in list(d.keys()):
            if isinstance(d[sect], dict):
                d[sect].pop("extra", None)
                for sub in d[sect].values():
                    if isinstance(sub, dict):
                        sub.pop("extra", None)
        d.pop("extra", None)
        return d

    def save(self, path: str) -> None:
        """Write the config as JSON (which is also YAML, so the JAX
        package's ``load_config`` reads it too)."""
        with open(path, "w") as f:
            json.dump(self.to_dict(), f, indent=2)
            f.write("\n")


def load_config(path: str) -> Config:
    """Load a YAML config file (reference CLI contract: --config path), or
    the JSON that ``Config.save`` writes; JSON needs no PyYAML."""
    with open(path) as f:
        text = f.read()
    try:
        raw = json.loads(text)
    except ValueError:
        import yaml

        raw = yaml.safe_load(text) or {}
    return Config.from_dict(raw)
