"""Downstream tasks (port of imageclassification_tpu/downstream/): the
ConvNeXt (or Swin) pyramid backbone with classifier weight transfer
(`backbone.py`), the per-size recipe tables (`configs.py`), UPerNet
segmentation (`upernet.py`, `seg_data.py`, `seg_engine.py`, driven by
`imageclassification_tpu_torch.seg_train`) and the detection FPN neck
(`fpn.py`)."""

from .backbone import ConvNeXtBackbone, load_backbone_from_classifier
from .configs import DETECTION_CONFIGS, SEGMENTATION_CONFIGS
