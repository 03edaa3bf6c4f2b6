"""Deterministic synthetic sources and host-side prefetch (counterpart of
``repro/data/pipeline.py``: ``SyntheticTokens``, ``SyntheticImages`` and
``Prefetcher``, numpy only).  For the same seed each source yields the
same bytes as the reference's copy; ``shard_batch`` gives a rank its
slice of a batch under the sharding rules."""
from __future__ import annotations

import queue
import threading
from typing import Iterator

import numpy as np


class SyntheticTokens:
    """LM token stream: (tokens, labels) with labels = next token."""

    def __init__(self, cfg, batch: int, seq_len: int, *, seed: int = 0):
        self.cfg = cfg
        self.batch = batch
        self.seq_len = seq_len
        self.rng = np.random.default_rng(seed)

    def __iter__(self) -> Iterator[dict]:
        return self

    def __next__(self) -> dict:
        # a deterministic, slightly-structured stream (zipfian-ish ids)
        z = self.rng.zipf(1.3, size=(self.batch, self.seq_len + 1))
        toks = (z % self.cfg.vocab_size).astype(np.int32)
        out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
        if self.cfg.m_rope:
            pos = np.broadcast_to(np.arange(self.seq_len, dtype=np.int32),
                                  (self.batch, self.seq_len))
            out["positions"] = np.broadcast_to(pos, (3, *pos.shape)).copy()
        if self.cfg.family == "audio":
            out["frames"] = self.rng.standard_normal(
                (self.batch, self.cfg.encdec.num_encoder_frames,
                 self.cfg.d_model), dtype=np.float32)
        return out


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


class Prefetcher:
    """Background-thread prefetch of host batches (depth-bounded queue).
    The worker is a named daemon thread that ends on :meth:`close` even
    when the queue is full (the reference's can stay blocked in ``put``)."""

    _POLL_S = 0.05

    def __init__(self, it: Iterator[dict], depth: int = 2):
        self.it = it
        self.q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True,
                                       name="prefetch")
        self.thread.start()

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self.q.put(item, timeout=self._POLL_S)
                return True
            except queue.Full:
                continue
        return False

    def _run(self):
        try:
            for item in self.it:
                if not self._put(item):
                    return
        finally:
            self._put(None)             # end of the source (or its error)

    def __iter__(self):
        return self

    def __next__(self):
        item = self.q.get()
        if item is None:
            raise StopIteration
        return item

    def close(self):
        """Stop the worker and wait for it to end."""
        self._stop.set()
        self.thread.join()


def shard_batch(batch: dict, mesh, rules, coordinate=None) -> dict:
    """This rank's local slice of each input of a host batch under the
    policy's batch sharding (the reference places the whole batch on the
    mesh; each device then holds this slice).  M-RoPE's (3, B, S)
    ``positions`` split along axis 1.  ``coordinate``: the rank's index
    along each mesh axis (default the calling rank's)."""
    from repro_torch.distributed.policy import batch_axes_for
    from repro_torch.distributed.sharding import local_slice
    out = {}
    for k, v in batch.items():
        # the policy's "positions" are M-RoPE's (3, B, S); any other
        # positions shard as the tokens do
        mrope = k == "positions" and v.ndim >= 3 and v.shape[0] == 3
        axes = batch_axes_for(k if mrope or k != "positions" else "", v.ndim)
        out[k] = v[local_slice(v.shape, rules.spec(list(axes)), mesh, coordinate)]
    return out
