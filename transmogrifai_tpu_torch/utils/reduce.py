"""Float sums in a fixed, stated order.

A float32 sum depends on the order of its additions.  The reference's sums
(votes over trees, metric integrals, grad/hess totals) are XLA reductions,
which XLA's CPU compiler splits into windows of 32: the axis is zero-padded
to a multiple of 32 (the padding split evenly, the odd one at the end), each
window is summed from 0 in order, and the window sums are reduced the same
way until one window is left.  :func:`window_sum` sums in exactly that order,
so a port sum over the same float32 values gives the reference's bits on any
device; ``torch.sum`` would not (its order differs between the CPU and CUDA).
"""

from __future__ import annotations

import torch

WINDOW = 32


def window_sum(t: torch.Tensor, dim: int = -1, window: int = WINDOW) -> torch.Tensor:
    """Sum of ``t`` over ``dim`` in windows of ``window``, recursively."""
    t = t.movedim(dim, 0)
    while t.shape[0] > window:
        n = t.shape[0]
        total = -(-n // window) * window
        lo = (total - n) // 2
        hi = total - n - lo
        rest = t.shape[1:]
        t = torch.cat([t.new_zeros((lo,) + rest), t, t.new_zeros((hi,) + rest)])
        t = t.reshape((total // window, window) + rest)
        acc = torch.zeros_like(t[:, 0])
        for j in range(window):
            acc = acc + t[:, j]
        t = acc
    acc = torch.zeros_like(t[0])
    for j in range(t.shape[0]):  # opcheck: allow(TM302) a loop over the <= 32 windows of a reduction, not rows
        acc = acc + t[j]
    return acc
