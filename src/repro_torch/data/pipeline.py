"""Deterministic synthetic image source for GoogLeNet (counterpart of
``repro/data/pipeline.py::SyntheticImages``, numpy only).  For the same
seed it yields the same bytes as the reference's copy."""
from __future__ import annotations

import numpy as np


class SyntheticImages:
    """ILSVRC-like image stream for GoogLeNet: (images, labels).

    Images are seeded Gaussian blobs around class-dependent means so that a
    *deterministic* mapping image->class exists (the FP16-vs-FP32 comparison
    needs the same inputs on both precisions, not real photos).
    """

    def __init__(self, num_classes: int = 1000, batch: int = 8,
                 size: int = 224, *, seed: int = 0):
        self.num_classes = num_classes
        self.batch = batch
        self.size = size
        self.rng = np.random.default_rng(seed)

    def sample(self, n: int) -> dict:
        labels = self.rng.integers(0, self.num_classes, size=n).astype(np.int32)
        base = (labels[:, None, None, None].astype(np.float32)
                / self.num_classes - 0.5)
        noise = self.rng.standard_normal(
            (n, self.size, self.size, 3), dtype=np.float32)
        return {"images": base + 0.5 * noise, "labels": labels}

    def __iter__(self):
        return self

    def __next__(self) -> dict:
        return self.sample(self.batch)
