"""Process-wide tuned-config table the kernel wrappers consult.  Port of
``repro/kernels/autotune/table.py``.

Kept dependency-free (the ``ops`` modules import this at call time and
the autotuner populates it), so there is no cycle between
``kernels/*/ops.py`` and the autotune package.  Lookup is by the same
``(kernel, shape-bucket, dtype)`` key the cache uses; a miss returns
``None`` and the wrapper keeps its default — an untuned process launches
exactly as before.
"""
from __future__ import annotations

import threading
from typing import Dict, Optional, Sequence

import numpy as np
import torch

_lock = threading.Lock()
_table: Dict[str, dict] = {}      # "kernel|bucket|dtype" -> config dict


def dtype_name(dtype) -> str:
    """Canonical dtype key: ``torch.float32``, ``np.float32``, a numpy
    dtype object and the string ``"float32"`` all map to ``"float32"``
    (and ``torch.bfloat16`` to ``"bfloat16"``, as JAX's bfloat16 does)."""
    if isinstance(dtype, torch.dtype):
        return str(dtype).rsplit(".", 1)[-1]
    try:
        return np.dtype(dtype).name
    except TypeError:
        return str(getattr(dtype, "name", dtype))


def shape_bucket(shape: Sequence[int]) -> str:
    """Dims rounded up to the next power of two: nearby shapes share a
    tuned config (the win is launch geometry, not the exact size)."""
    dims = []
    for d in shape:
        d = int(d)
        p = 1
        while p < d:
            p <<= 1
        dims.append(p)
    return "x".join(str(d) for d in dims)


def table_key(kernel: str, shape: Sequence[int], dtype) -> str:
    return f"{kernel}|{shape_bucket(shape)}|{dtype_name(dtype)}"


def install(entries: Dict[str, dict]) -> None:
    """Replace the installed table (``entries``: table_key -> config)."""
    with _lock:
        _table.clear()
        _table.update(entries)


def clear() -> None:
    with _lock:
        _table.clear()


def tuned_config(kernel: str, shape: Sequence[int],
                 dtype) -> Optional[dict]:
    """The installed winning config for this call site, or None."""
    if not _table:
        return None
    with _lock:
        return _table.get(table_key(kernel, shape, dtype))


def installed_count() -> int:
    with _lock:
        return len(_table)
