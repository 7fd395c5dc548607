"""Edge-case inputs for the port's encode kernel (``perf/kernels/encode.py``).

Shared by tests/test_torch_encode.py (the plain version against the JAX
package, on the CPU), tests/test_torch_cuda.py (the kernel against the plain
version, on the card) and ``chip_smoke.py``'s fused-kernel phase.  Imports
numpy, torch and the port only.
"""

import numpy as np
import torch

from transmogrifai_tpu_torch.perf.kernels import encode as KE


def _edge_values(rng, n: int, splits) -> np.ndarray:
    """Values with NaN every 7th row and, first, +-inf and every finite split."""
    a = rng.normal(size=n).astype(np.float32)
    a[::7] = np.nan
    fin = np.asarray(splits, np.float32)
    edge = np.concatenate([[np.inf, -np.inf], fin[np.isfinite(fin)]])[:n]
    a[:len(edge)] = edge
    return a


def slot_case(n: int, seed: int, device, n_slots: int = 12):
    """A random slot table over every edge case and its inputs on
    ``device``: one-hot slots with codes -1, width and width+5; bucketize
    slots with S = 2 and 5, all four track flag settings (track_nulls off
    among them), infinite edges, NaN, +-inf and values exactly on a split."""
    rng = np.random.default_rng(seed)
    specs, inputs = [], []
    for k in range(n_slots):
        if k % 2 == 0:
            w = int(rng.integers(1, 30))
            specs.append(KE.onehot_slot(w))
            a = rng.integers(-3, w + 7, n).astype(np.int32)
            a[:3] = [-1, w, w + 5][:n]
        else:
            S = (2, 5)[(k // 2) % 2]
            sp = np.sort(rng.normal(size=S)).astype(np.float32)
            if k % 3 == 0:
                sp[0], sp[-1] = -np.inf, np.inf
            specs.append(KE.bucketize_slot(sp, bool(k & 2), bool(k & 4)))
            a = _edge_values(rng, n, sp)
        inputs.append(torch.from_numpy(a).to(device))
    return specs, inputs


def fixture_inputs(table, n: int, seed: int, device):
    """Inputs for every slot of ``table``: codes with out-of-range values,
    values with NaN, +-inf and every finite split."""
    rng = np.random.default_rng(seed)
    out = []
    for s in table.specs:
        if s.kind == KE.ONEHOT:
            a = rng.integers(-1, s.width + 6, n).astype(np.int32)
        else:
            a = _edge_values(rng, n, s.splits)
        out.append(torch.from_numpy(a).to(device))
    return out
