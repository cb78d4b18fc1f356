"""Per-class precision/recall (copy of imageclassification_tpu/utils/metrics.py
`per_class_precision_recall`)."""

from __future__ import annotations


def per_class_precision_recall(tp, fp, fn):
    """Elementwise precision/recall with zero-denominator guards."""
    precision = [
        float(t) / (t + f) if t + f > 0 else 0.0 for t, f in zip(tp, fp)
    ]
    recall = [
        float(t) / (t + f) if t + f > 0 else 0.0 for t, f in zip(tp, fn)
    ]
    return precision, recall
