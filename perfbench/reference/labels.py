"""Segmentation label taxonomy and the 19 -> 12 class map.

The internal mask format is the reference's 12-class "faceParser detailed"
taxonomy (reference datasets/dataset.py:30):

    0 background, 1 lip, 2 eyebrows, 3 eyes, 4 hair, 5 nose, 6 skin,
    7 ears, 8 belowface(neck), 9 mouth(teeth), 10 eye_glass, 11 ear_rings

The BiSeNet parser and the FFHQ label maps use the face-parsing.PyTorch
19-class taxonomy, CelebAMask-HQ its own; this module keeps its own copy of
the lookup tables of `e4s2024_tpu/data/labels.py`. The converters take
numpy arrays (and return numpy) or tensors (and map them on their device).

A frozen copy of `e4s2024_torch/data/labels.py` for the benchmark's plain
reference: no kernel, no split, no process group; it imports nothing of
the port.
"""

from __future__ import annotations

import numpy as np
import torch

FACE_PARSER_LABELS = [
    "background", "lip", "eyebrows", "eyes", "hair", "nose", "skin",
    "ears", "belowface", "mouth", "eye_glass", "ear_rings",
]
NUM_SEG_CLASSES = len(FACE_PARSER_LABELS)

# face-parsing.PyTorch taxonomy -> 12 classes (reference dataset.py:58-108);
# unmapped classes (cloth, neck_l, hat) fall to background.
FFHQ_TO_12 = np.zeros(19, dtype=np.int64)
for _src, _dst in {
    1: 6,           # skin
    2: 2, 3: 2,     # brows
    4: 3, 5: 3,     # eyes
    6: 10,          # eye_g
    7: 7, 8: 7,     # ears
    9: 11,          # ear_r
    10: 5,          # nose
    11: 9,          # mouth interior
    12: 1, 13: 1,   # lips
    14: 8,          # neck
    17: 4,          # hair
}.items():
    FFHQ_TO_12[_src] = _dst


def map_labels(labels: torch.Tensor, lut: np.ndarray = FFHQ_TO_12) -> torch.Tensor:
    """Apply an integer lookup table to a label map as one gather."""
    table = torch.as_tensor(lut, dtype=labels.dtype, device=labels.device)
    return table[labels]
