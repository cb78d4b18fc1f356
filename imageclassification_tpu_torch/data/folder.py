"""Folder dataset index (own copy of imageclassification_tpu/data/folder.py).

`scan_folder` indexes `root/<class>/**` with classes in alphabetical order
(torchvision ImageFolder convention); `split_dataset` auto-splits with an
equal validation count per class derived from the smallest class;
`write_class_indices` writes the inverted `{idx: name}` map that val.py reads
back next to a checkpoint. Only paths are indexed — no pixels are read.
"""

from __future__ import annotations

import json
import os
import random
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Tuple

IMG_EXTENSIONS = (
    ".jpg", ".jpeg", ".png", ".ppm", ".bmp", ".pgm", ".tif", ".tiff", ".webp",
)


@dataclass
class ImageFolderIndex:
    """A dataset as an index of (path, label) pairs — no pixels held in memory."""

    samples: List[Tuple[str, int]]
    class_to_idx: Dict[str, int]

    def __len__(self) -> int:
        return len(self.samples)

    @property
    def num_classes(self) -> int:
        return len(self.class_to_idx)

    @property
    def targets(self) -> List[int]:
        return [label for _, label in self.samples]


def scan_folder(root: str) -> ImageFolderIndex:
    """Scan `root/<class>/**` for images; classes sorted alphabetically."""
    root = os.path.expanduser(root)
    classes = sorted(d.name for d in os.scandir(root) if d.is_dir())
    if not classes:
        raise FileNotFoundError(f"No class folders found in {root}")
    class_to_idx = {c: i for i, c in enumerate(classes)}
    samples: List[Tuple[str, int]] = []
    for cls in classes:
        cls_dir = os.path.join(root, cls)
        for dirpath, _, filenames in sorted(os.walk(cls_dir)):
            for fname in sorted(filenames):
                if fname.lower().endswith(IMG_EXTENSIONS):
                    samples.append((os.path.join(dirpath, fname), class_to_idx[cls]))
    if not samples:
        raise FileNotFoundError(f"No images found in {root}")
    return ImageFolderIndex(samples, class_to_idx)


def split_dataset(
    root: str, train_ratio: float = 0.5, seed: int | None = None
) -> Tuple[ImageFolderIndex, ImageFolderIndex, Dict[str, int]]:
    """Auto-split with equal per-class val counts:
    val_per_class = min_class_size - int(min_class_size * train_ratio); each
    class's shuffled list gives its LAST val_per_class samples to val."""
    index = scan_folder(root)
    rng = random.Random(seed)

    by_class: Dict[int, List[int]] = {}
    for i, (_, label) in enumerate(index.samples):
        by_class.setdefault(label, []).append(i)

    min_class_size = min(len(v) for v in by_class.values())
    val_per_class = min_class_size - int(min_class_size * train_ratio)

    train_idx: List[int] = []
    val_idx: List[int] = []
    for label in sorted(by_class):
        idxs = list(by_class[label])
        rng.shuffle(idxs)
        if val_per_class > 0:
            train_idx.extend(idxs[:-val_per_class])
            val_idx.extend(idxs[-val_per_class:])
        else:
            train_idx.extend(idxs)

    train_ds = ImageFolderIndex([index.samples[i] for i in train_idx], index.class_to_idx)
    val_ds = ImageFolderIndex([index.samples[i] for i in val_idx], index.class_to_idx)

    idx_to_class = {v: k for k, v in index.class_to_idx.items()}
    train_counts = {c: 0 for c in index.class_to_idx}
    val_counts = {c: 0 for c in index.class_to_idx}
    for _, label in train_ds.samples:
        train_counts[idx_to_class[label]] += 1
    for _, label in val_ds.samples:
        val_counts[idx_to_class[label]] += 1
    print("Train samples per class:", train_counts)
    print("Val samples per class:", val_counts)

    return train_ds, val_ds, index.class_to_idx


def write_class_indices(class_to_idx: Dict[str, int], output_dir: str) -> None:
    """Write the inverted {idx: name} map to class_indices.json."""
    Path(output_dir).mkdir(parents=True, exist_ok=True)
    json_str = json.dumps({v: k for k, v in class_to_idx.items()}, indent=4)
    with open(Path(output_dir) / "class_indices.json", "w") as f:
        f.write(json_str)


def build_dataset(args) -> Tuple[ImageFolderIndex, ImageFolderIndex, int]:
    """(train, val, num_classes): `train/` and `val/` folders when
    train_split_rato == 0, else the seeded auto-split of data_path; writes
    class_indices.json into output_dir."""
    if args.train_split_rato == 0:
        train_ds = scan_folder(os.path.join(args.data_path, "train"))
        val_ds = scan_folder(os.path.join(args.data_path, "val"))
        class_to_idx = train_ds.class_to_idx
    else:
        train_ds, val_ds, class_to_idx = split_dataset(
            args.data_path, args.train_split_rato, seed=args.seed
        )
    write_class_indices(class_to_idx, args.output_dir)
    num_classes = len(class_to_idx)
    print("Number of the class = %d" % num_classes)
    return train_ds, val_ds, num_classes
