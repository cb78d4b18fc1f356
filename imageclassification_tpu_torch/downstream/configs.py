"""Per-size downstream training recipes (port of
imageclassification_tpu/downstream/configs.py, copied: the port imports
nothing of the JAX package).

Every hyperparameter below is read off the reference's mmdet/mmseg configs
(cited per field), as in the JAX package.

Detection (object_detection/configs/convnext/*.py):
  * Cascade Mask R-CNN, 3x (36 epochs), multi-scale train 480-800 short side
    (cascade_mask_rcnn_convnext_tiny_...py:90-127), AdamW + layer_wise decay
    (":130-134"), fp16 (":136-147").
Segmentation (semantic_segmentation/configs/convnext/*.py):
  * UPerNet + FCN aux head, 160k iters, poly LR with 1500-iter linear warmup
    (upernet_convnext_tiny_512_160k_ade20k_ss.py:36-46), crop 512 (640 for the
    22k-pretrained B/L/XL), slide-window eval crop 512 stride 341 (":33"),
    2 img/GPU x 8 GPUs (":49").
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple


@dataclass(frozen=True)
class DetectionConfig:
    backbone: str
    detector: str                     # 'mask_rcnn' | 'cascade_mask_rcnn'
    drop_path_rate: float
    lr: float = 0.0002                # AdamW (cascade...tiny:131)
    weight_decay: float = 0.05
    layer_decay_rate: float = 0.7     # layer_wise decay_rate (":133")
    layer_decay_num_layers: int = 6   # (":133")
    epochs: int = 36                  # 3x schedule (":139")
    lr_milestones: Tuple[int, ...] = (27, 33)
    train_short_sides: Tuple[int, ...] = (480, 512, 544, 576, 608, 640, 672,
                                          704, 736, 768, 800)  # (":97-104")
    train_max_side: int = 1333
    use_fp16: bool = True             # DistOptimizerHook use_fp16 (":147")
    pretrained: Optional[str] = None  # classification ckpt for the backbone


@dataclass(frozen=True)
class SegmentationConfig:
    backbone: str
    drop_path_rate: float
    crop_size: int                    # 512 or 640
    lr: float                         # AdamW (tiny ss:37; xlarge ss: 8e-5)
    weight_decay: float = 0.05
    decay_type: str = "stage_wise"    # every ss config uses stage_wise (":39")
    layer_decay_rate: float = 0.9
    layer_decay_num_layers: int = 12  # paramwise num_layers (tiny: 6, ":40")
    total_iters: int = 160_000        # IterBasedRunnerAmp (":52")
    warmup_iters: int = 1500          # poly warmup (":42-46")
    power: float = 1.0
    min_lr: float = 0.0
    batch_per_host: int = 16          # 2 img/GPU × 8 (":49")
    eval_stride: int = 341            # slide test (":33"; 426 for 640 crops)
    aux_head: bool = True             # FCN aux head (base model :10-49)
    pretrained: Optional[str] = None


# reference per-size tables (object_detection/README.md:12-18 rows)
DETECTION_CONFIGS = {
    "mask_rcnn_convnext_tiny_3x": DetectionConfig(
        backbone="convnext_tiny", detector="mask_rcnn", drop_path_rate=0.4),
    "cascade_mask_rcnn_convnext_tiny_3x": DetectionConfig(
        backbone="convnext_tiny", detector="cascade_mask_rcnn", drop_path_rate=0.4),
    "cascade_mask_rcnn_convnext_small_3x": DetectionConfig(
        backbone="convnext_small", detector="cascade_mask_rcnn", drop_path_rate=0.6),
    "cascade_mask_rcnn_convnext_base_3x": DetectionConfig(
        backbone="convnext_base", detector="cascade_mask_rcnn", drop_path_rate=0.7),
    "cascade_mask_rcnn_convnext_base_22k_3x": DetectionConfig(
        backbone="convnext_base", detector="cascade_mask_rcnn", drop_path_rate=0.8),
    "cascade_mask_rcnn_convnext_large_22k_3x": DetectionConfig(
        backbone="convnext_large", detector="cascade_mask_rcnn", drop_path_rate=0.8,
        layer_decay_rate=0.8),
    "cascade_mask_rcnn_convnext_xlarge_22k_3x": DetectionConfig(
        backbone="convnext_xlarge", detector="cascade_mask_rcnn", drop_path_rate=0.8,
        layer_decay_rate=0.8),
}

# reference per-size tables, every field read off the vendored ss configs
# (semantic_segmentation/configs/convnext/upernet_convnext_*_ss.py: crop_size,
# drop_path_rate, test_cfg stride, optimizer lr/paramwise_cfg). All use
# stage_wise decay 0.9; tiny alone sets paramwise num_layers=6; lr is 1e-4
# except xlarge's 8e-5; 640-crop configs slide-test at stride 426.
SEGMENTATION_CONFIGS = {
    "upernet_convnext_tiny_512_160k": SegmentationConfig(
        backbone="convnext_tiny", drop_path_rate=0.4, crop_size=512, lr=1e-4,
        layer_decay_num_layers=6),
    "upernet_convnext_small_512_160k": SegmentationConfig(
        backbone="convnext_small", drop_path_rate=0.3, crop_size=512, lr=1e-4),
    "upernet_convnext_base_512_160k": SegmentationConfig(
        backbone="convnext_base", drop_path_rate=0.4, crop_size=512, lr=1e-4),
    "upernet_convnext_base_22k_640_160k": SegmentationConfig(
        backbone="convnext_base", drop_path_rate=0.4, crop_size=640, lr=1e-4,
        eval_stride=426),
    "upernet_convnext_large_22k_640_160k": SegmentationConfig(
        backbone="convnext_large", drop_path_rate=0.4, crop_size=640, lr=1e-4,
        eval_stride=426),
    "upernet_convnext_xlarge_22k_640_160k": SegmentationConfig(
        backbone="convnext_xlarge", drop_path_rate=0.4, crop_size=640, lr=8e-5,
        eval_stride=426),
}
