"""Fitted constants of a stage, moved once to each device that uses them."""

from __future__ import annotations

import contextlib
import contextvars
from typing import Dict, Optional

import numpy as np
import torch

#: while a serving plan's prefix runs, the store of its device-side state
#: (``serve/plan.py``): the constants go there, and leave the card with it
_STORE: "contextvars.ContextVar[Optional[Dict[tuple, torch.Tensor]]]" = \
    contextvars.ContextVar("device_const_store", default=None)


@contextlib.contextmanager
def const_store(store: Dict[tuple, torch.Tensor]):
    """Keep the constants :func:`device_const` moves inside the block in
    ``store`` (keyed by stage identity, key and device) instead of on the
    stages."""
    token = _STORE.set(store)
    try:
        yield store
    finally:
        _STORE.reset(token)


def device_const(stage, key: str, value, dtype: np.dtype,
                 device: torch.device) -> torch.Tensor:
    """``value`` as a tensor of numpy ``dtype`` on ``device``, cached per
    (key, device) on the stage, or in the active :func:`const_store`: the
    serving prefix reuses it every batch instead of copying it to the card
    again."""
    store = _STORE.get()
    if store is None:
        cache, k = stage.__dict__.setdefault("_device_consts", {}), (key, device)
    else:
        cache, k = store, (id(stage), key, device)
    t = cache.get(k)
    if t is None:
        t = torch.from_numpy(np.array(value, dtype=dtype)).to(device)
        cache[k] = t
    return t
