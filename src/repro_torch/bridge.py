"""Move parameters between the JAX package and the port as numpy arrays.

The reference hands its parameter tree over as numpy arrays (the caller
converts with ``np.asarray``); :func:`to_torch` turns each leaf into a
tensor on a device and keeps the tree, so the stacked ``blocks`` leaves
(leading layer dim, ``repro/models/transformer.py``) stay stacked.

``torch.from_numpy`` refuses ``ml_dtypes.bfloat16`` arrays, so a bf16 leaf
is reinterpreted bit for bit: viewed as uint16, wrapped, then viewed as
``torch.bfloat16``. :func:`to_numpy` goes back the same way and returns a
bf16 tensor as its raw uint16 bits: the port imports neither ``ml_dtypes``
nor ``jax``, so it cannot name numpy's bfloat16 type itself; a caller that
has it calls ``.view(ml_dtypes.bfloat16)``.
"""
from __future__ import annotations

import numpy as np
import torch


def _leaf_to_torch(arr: np.ndarray, device) -> torch.Tensor:
    arr = np.array(arr, order="C")          # an owned, writable copy
    if arr.dtype.name == "bfloat16":
        t = torch.from_numpy(arr.view(np.uint16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(arr)
    return t.to(device)


def to_torch(tree, device="cuda"):
    """Nested dict of numpy arrays -> the same nesting of tensors."""
    if isinstance(tree, dict):
        return {k: to_torch(v, device) for k, v in tree.items()}
    return _leaf_to_torch(np.asarray(tree), device)


def to_numpy(tree):
    """Nested dict of tensors -> numpy arrays on the host; bf16 leaves come
    back as their uint16 bit patterns."""
    if isinstance(tree, dict):
        return {k: to_numpy(v) for k, v in tree.items()}
    t = tree.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()
