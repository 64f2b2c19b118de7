"""Datasets: CelebA-HQ / FFHQ face and mask pairs (counterpart of
`e4s2024_tpu/data/datasets.py`; reference datasets/dataset.py:260
`CelebAHQDataset`, :502 `FFHQDataset`). The video tunes take their
per-frame arrays directly (`training.pti`), so the JAX package's two
video containers, which nothing builds, have no counterpart.

Items are numpy HWC, as the JAX package's: images float32 in [-1, 1],
labels int32 12-class maps. `FaceMaskDataset.batches` stacks them into the
trainer's NCHW batches, img (B, 3, S, S) and onehot (B, K, M, M), each
rank on its `(rank, world)` shard. PIL is imported by the functions that
read files only.
"""

from __future__ import annotations

import os
import os.path as osp
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from e4s2024_torch.data.labels import celebahq19_to_face12, ffhq19_to_face12
from e4s2024_torch.utils.image import to_pm1

IMG_EXTENSIONS = (".jpg", ".jpeg", ".png", ".bmp", ".webp")


def list_images(root: str) -> list[str]:
    """Every image file under `root`, walked in sorted order (reference
    datasets/utils.py:34 `make_dataset`)."""
    out = []
    for dirpath, _, files in sorted(os.walk(root)):
        for f in sorted(files):
            if f.lower().endswith(IMG_EXTENSIONS):
                out.append(osp.join(dirpath, f))
    return out


def _load_image(path: str, size: int | None = None) -> np.ndarray:
    from PIL import Image

    img = Image.open(path).convert("RGB")
    if size is not None and img.size != (size, size):
        img = img.resize((size, size), Image.BILINEAR)
    return np.asarray(img)


def _load_label(path: str, size: int | None = None) -> np.ndarray:
    from PIL import Image

    lbl = Image.open(path)
    if lbl.mode not in ("L", "P"):
        lbl = lbl.convert("L")
    if size is not None and lbl.size != (size, size):
        lbl = lbl.resize((size, size), Image.NEAREST)
    return np.asarray(lbl)


@dataclass
class FaceMaskDataset:
    """(image, 12-class label) pairs from parallel images/ and labels/ trees.

    `label_format`: "celebahq19" | "ffhq19" | "face12" (already converted).
    With `mode` the layout is CelebAHQDataset's root/{mode}/{images,labels}
    ("all": train and test), else a flat root/{images,labels}. `fraction`
    keeps the first part of each listing; `flip_p` flips an item
    horizontally with that probability; `paired` yields (source, target)
    pairs of consecutive items.
    """

    root: str
    mode: str | None = None
    label_format: str = "celebahq19"
    image_size: int | None = None
    label_size: int | None = None
    fraction: float = 1.0
    flip_p: float = -1.0
    paired: bool = False
    seed: int = 0

    def __post_init__(self):
        if self.mode == "all":
            roots = [osp.join(self.root, "train"), osp.join(self.root, "test")]
        elif self.mode:
            roots = [osp.join(self.root, self.mode)]
        else:
            roots = [self.root]
        self.imgs, self.labels = [], []
        for r in roots:
            imgs = list_images(osp.join(r, "images"))
            labels = list_images(osp.join(r, "labels"))
            self.imgs.extend(imgs[: int(len(imgs) * self.fraction)])
            self.labels.extend(labels[: int(len(labels) * self.fraction)])
        if len(self.imgs) != len(self.labels):
            raise ValueError(f"images/labels mismatch: {len(self.imgs)} vs {len(self.labels)}")
        self._rng = np.random.default_rng(self.seed)
        self._convert = {
            "celebahq19": celebahq19_to_face12,
            "ffhq19": ffhq19_to_face12,
            "face12": lambda x: x,
        }[self.label_format]

    def __len__(self):
        return len(self.imgs) // (2 if self.paired else 1)

    def load(self, i: int):
        """Item i: (image (S, S, 3) float32 in [-1, 1], label (M, M) int32)."""
        img = _load_image(self.imgs[i], self.image_size)
        lbl = self._convert(_load_label(self.labels[i], self.label_size))
        if self.flip_p > 0 and self._rng.random() < self.flip_p:
            img = img[:, ::-1]
            lbl = lbl[:, ::-1]
        return to_pm1(img), lbl.astype(np.int32)

    def __getitem__(self, i: int):
        if not self.paired:
            return self.load(i)
        return self.load(2 * i), self.load(2 * i + 1)

    def batches(self, batch_size: int, *, num_classes: int = 12,
                onehot_size: int | None = 512, shuffle: bool = True,
                shard: tuple[int, int] | None = None) -> Iterator[tuple]:
        """Yield (img (B, 3, S, S) in [-1, 1], onehot (B, K, M, M)) float32
        numpy batches forever, full batches only, reshuffled each pass.
        Labels are resized nearest to `onehot_size`. shard: (rank, world),
        this rank's share of the items."""
        idx = np.arange(len(self.imgs))
        if shard is not None:
            idx = idx[shard[0]::shard[1]]
        while True:
            order = self._rng.permutation(idx) if shuffle else idx
            for start in range(0, len(order) - batch_size + 1, batch_size):
                sel = order[start:start + batch_size]
                imgs, lbls = zip(*(self.load(int(i)) for i in sel))
                img = np.stack(imgs)
                lbl = np.stack(lbls)
                if onehot_size is not None and lbl.shape[1] != onehot_size:
                    ih = (np.arange(onehot_size) * lbl.shape[1]) // onehot_size
                    lbl = lbl[:, ih][:, :, ih]
                onehot = np.eye(num_classes, dtype=np.float32)[lbl]
                yield (np.ascontiguousarray(img.transpose(0, 3, 1, 2)),
                       np.ascontiguousarray(onehot.transpose(0, 3, 1, 2)))

