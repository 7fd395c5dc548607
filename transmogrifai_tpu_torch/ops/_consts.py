"""Fitted constants of a stage, moved once to each device that uses them."""

from __future__ import annotations

import numpy as np
import torch


def device_const(stage, key: str, value, dtype: np.dtype,
                 device: torch.device) -> torch.Tensor:
    """``value`` as a tensor of numpy ``dtype`` on ``device``, cached on the
    stage per (key, device): the serving prefix reuses it every batch instead
    of copying it to the card again."""
    cache = stage.__dict__.setdefault("_device_consts", {})
    t = cache.get((key, device))
    if t is None:
        t = torch.from_numpy(np.array(value, dtype=dtype)).to(device)
        cache[(key, device)] = t
    return t
