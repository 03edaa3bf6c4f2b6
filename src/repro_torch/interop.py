"""Parameter hand-over from the JAX reference.

:func:`params_from_numpy` turns the reference's parameter pytree -- handed
over as numpy arrays (``np.asarray`` on each JAX leaf, done by the caller)
-- into this package's parameters, one leaf to one tensor, with the same
names and shapes.  bf16 crosses by bitcast: ``torch.from_numpy`` rejects
``ml_dtypes.bfloat16`` arrays, so their bits go through uint16 -> int16 and
are viewed as ``torch.bfloat16``.  Nothing here imports jax.
"""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def tensor_from_numpy(a: np.ndarray, device="cpu") -> torch.Tensor:
    """One numpy array (incl. ml_dtypes bfloat16) -> a tensor on ``device``."""
    a = np.array(a, copy=True, order="C")   # writable, contiguous
    if a.dtype.name == "bfloat16":
        bits = torch.from_numpy(a.view(np.uint16).view(np.int16))
        return bits.view(torch.bfloat16).to(device)
    return torch.from_numpy(a).to(device)


def params_from_numpy(tree: Any, device="cpu") -> Any:
    """Nested dict/list of numpy arrays -> same structure of tensors."""
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(params_from_numpy(v, device) for v in tree)
    return tensor_from_numpy(np.asarray(tree), device)
