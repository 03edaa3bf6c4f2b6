"""NumPy-backed checkpointer: per-process leaf files, atomic commit,
optional async save, retention, auto-resume (counterpart of
``repro/checkpoint/checkpoint.py``, with its on-disk layout, so a
checkpoint written by the reference restores here).

Layout:
  <dir>/step_00000100/            (committed atomically via rename)
    MANIFEST.json                 {leaf name -> file, shape, dtype}
    p0000_<leaf>.npy              one file per leaf per process
  <dir>/LATEST                    text file with the last committed step

Leaf names are the reference's: the leaf's path as ``jax.tree_util``
prints it (``['params']['blocks']['attn']['wq']``), every run of other
characters than ``[A-Za-z0-9_.]`` made one ``_``.  bf16 leaves are stored
as the reference's numpy stores them without ``ml_dtypes``: two raw bytes
an element (``V2``), with ``bfloat16`` in the manifest; they cross back to
``torch.bfloat16`` by bitcast.

Commit order (write tmp -> fsync -> rename -> update LATEST) guarantees a
crash never leaves a half checkpoint visible.  The parameters and
optimizer state are updated in place by the next step, so ``save`` copies
every leaf to host memory before it returns; only the disk write runs on
the background thread.
"""
from __future__ import annotations

import json
import os
import re
import shutil
import threading
from typing import Any, Iterator, Mapping

import numpy as np
import torch

Pytree = Any


def _leaf_name(path: tuple) -> str:
    s = "".join(f"[{k!r}]" if isinstance(k, str) else f"[{k}]" for k in path)
    return re.sub(r"[^A-Za-z0-9_.]+", "_", s).strip("_")


def _leaves_with_path(tree: Pytree, path: tuple = ()) -> Iterator[tuple[tuple, Any]]:
    """(path, leaf) of a nested dict / list, dict keys sorted (the
    reference's order)."""
    if isinstance(tree, Mapping):
        for k in sorted(tree):
            yield from _leaves_with_path(tree[k], path + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves_with_path(v, path + (i,))
    else:
        yield path, tree


def _rebuild(like: Pytree, it: Iterator) -> Pytree:
    if isinstance(like, Mapping):
        vals = {k: _rebuild(like[k], it) for k in sorted(like)}
        return {k: vals[k] for k in like}
    if isinstance(like, (list, tuple)):
        return type(like)(_rebuild(v, it) for v in like)
    return next(it)


def _snapshot(leaf) -> tuple[np.ndarray, str]:
    """A host copy of one leaf that nothing else shares, and its dtype name."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.dtype("V2")), "bfloat16"
        arr = t.numpy()
    else:
        arr = np.array(leaf, copy=True)
    return arr, str(arr.dtype)


def _restored(arr: np.ndarray, like):
    """The loaded array as ``like`` holds it: a tensor of like's dtype on
    like's device, or a numpy array."""
    if not isinstance(like, torch.Tensor):
        return arr
    if arr.dtype.kind == "V":                      # bf16 bits
        t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr))        # keeps a 0-d leaf 0-d
    return t.to(device=like.device, dtype=like.dtype)


# One process writes every leaf; its files carry the reference's
# single-host prefix.
_PROC = 0


class Checkpointer:
    def __init__(self, directory: str, *, keep: int = 3,
                 async_save: bool = True):
        self.directory = directory
        self.keep = keep
        self.async_save = async_save
        self._thread: threading.Thread | None = None
        os.makedirs(directory, exist_ok=True)

    # -- save -----------------------------------------------------------------

    def save(self, step: int, tree: Pytree) -> None:
        """Copy every leaf to host memory now; write to disk (maybe async)."""
        host = [(path, *_snapshot(leaf)) for path, leaf in _leaves_with_path(tree)]
        self.wait()
        if self.async_save:
            self._thread = threading.Thread(
                target=self._write, args=(step, host), daemon=True,
                name="checkpoint-writer")
            self._thread.start()
        else:
            self._write(step, host)

    def _write(self, step: int, host_leaves) -> None:
        proc = _PROC
        final = os.path.join(self.directory, f"step_{step:08d}")
        tmp = final + f".tmp{proc}"
        os.makedirs(tmp, exist_ok=True)
        manifest = {}
        for path, arr, dtype in host_leaves:
            name = f"p{proc:04d}_{_leaf_name(path)}"
            np.save(os.path.join(tmp, name + ".npy"), arr)
            manifest[_leaf_name(path)] = {
                "file": name + ".npy",
                "shape": list(arr.shape),
                "dtype": dtype,
            }
        with open(os.path.join(tmp, "MANIFEST.json"), "w") as f:
            json.dump({"step": step, "leaves": manifest}, f, indent=1)
        for fname in os.listdir(tmp):
            fd = os.open(os.path.join(tmp, fname), os.O_RDONLY)
            os.fsync(fd)
            os.close(fd)
        if os.path.isdir(final):
            shutil.rmtree(final)
        os.rename(tmp, final)
        with open(os.path.join(self.directory, "LATEST.tmp"), "w") as f:
            f.write(str(step))
        os.replace(os.path.join(self.directory, "LATEST.tmp"),
                   os.path.join(self.directory, "LATEST"))
        self._retain()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _retain(self) -> None:
        steps = self.all_steps()
        for s in steps[:-self.keep]:
            shutil.rmtree(os.path.join(self.directory, f"step_{s:08d}"),
                          ignore_errors=True)

    # -- restore ----------------------------------------------------------------

    def all_steps(self) -> list[int]:
        out = []
        for d in os.listdir(self.directory):
            m = re.fullmatch(r"step_(\d+)", d)
            if m:
                out.append(int(m.group(1)))
        return sorted(out)

    def latest_step(self) -> int | None:
        p = os.path.join(self.directory, "LATEST")
        if not os.path.exists(p):
            return None
        with open(p) as f:
            step = int(f.read().strip())
        if os.path.isdir(os.path.join(self.directory, f"step_{step:08d}")):
            return step
        # fall back to the newest fully-committed directory
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, step: int, like: Pytree) -> Pytree:
        """Restore into the structure of ``like``: new tensors of each
        tensor leaf's dtype on its device (numpy arrays for other leaves)."""
        self.wait()
        d = os.path.join(self.directory, f"step_{step:08d}")
        proc = _PROC
        out = []
        for path, leaf in _leaves_with_path(like):
            name = f"p{proc:04d}_{_leaf_name(path)}.npy"
            arr = np.load(os.path.join(d, name))
            if hasattr(leaf, "shape") and tuple(arr.shape) != tuple(leaf.shape):
                raise ValueError(
                    f"checkpoint shape mismatch at {_leaf_name(path)}: "
                    f"{arr.shape} vs {tuple(leaf.shape)}")
            out.append(_restored(arr, leaf))
        return _rebuild(like, iter(out))

    def restore_latest(self, like: Pytree) -> tuple[int, Pytree] | None:
        step = self.latest_step()
        if step is None:
            return None
        return step, self.restore(step, like)
