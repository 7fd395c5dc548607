"""The port's collectives: every cross-rank call of a train goes through here.

The reference never writes a collective: XLA inserts the ``psum``s and
all-gathers from sharding annotations.  torch's idiom is one process per
card, so the port names each one.  Three calls cover a meshed train:

- :func:`all_reduce` — the row reductions (histograms, gradients,
  Hessians, moments, normal equations) over the mesh's ``data`` group;
- :func:`all_gather_rows` — per-rank row blocks back into the table's row
  order (metric payloads, the training flush's output columns), or a
  ``model`` group's parts of a sweep's score table;
- :func:`broadcast` — rank 0's tensor to every rank of a group.

:func:`ring_exchange` is the ring's one step (``parallel/wide.py``), the
reference's ``ppermute``.

On meta operands (a static trace, ``checkers/plancheck.py``) a call runs
nothing: it hands the trace a collective node
(``perf/kernels/trace.py::record_collective``) and returns meta results of
the right shape, with or without a process group.

Each call adds one to its count and its operand bytes to the byte count
(:func:`collective_counts`), by operation and backend; without a group (a
mesh of one process that made none) a call is the identity and counts
nothing.  Under NCCL every call is NCCL's own on the card's tensors:
nothing stages through the host.  Gloo (CPU ranks, or two ranks sharing one
card, which NCCL refuses: "Duplicate GPU detected") reduces, broadcasts and
gathers CUDA tensors by staging them through the host; its ring step on CUDA
tensors is an ``all_reduce`` of a zero buffer each rank fills at its
successor's slot, which is exact (every cell is one rank's value plus
zeros).
"""

from __future__ import annotations

import threading
from typing import Dict, List

import torch

#: operation -> backend -> [calls, bytes]
_COUNTS: Dict[str, Dict[str, List[int]]] = {}
_COUNT_LOCK = threading.Lock()


def _note(op: str, backend: str, nbytes: int) -> None:
    with _COUNT_LOCK:
        c = _COUNTS.setdefault(op, {}).setdefault(backend, [0, 0])
        c[0] += 1
        c[1] += int(nbytes)


def collective_counts() -> Dict[str, Dict[str, Dict[str, int]]]:
    """{operation: {backend: {"calls": n, "bytes": b}}} since the last
    :func:`reset_collective_counts`."""
    with _COUNT_LOCK:
        return {op: {be: {"calls": c[0], "bytes": c[1]} for be, c in by.items()}
                for op, by in _COUNTS.items()}


def reset_collective_counts() -> None:
    with _COUNT_LOCK:
        _COUNTS.clear()


def _backend(group) -> str:
    import torch.distributed as dist

    return str(dist.get_backend(group)).lower()


def _live(group) -> bool:
    return group is not None


def _traced(op: str, t: torch.Tensor) -> bool:
    """True (and the trace told) when ``t`` is a meta operand."""
    if t.device.type != "meta":
        return False
    from ..perf.kernels import trace

    trace.record_collective(op, t.numel() * t.element_size())
    return True


def all_reduce(t: torch.Tensor, group, op: str = "sum") -> torch.Tensor:
    """The elementwise ``op`` ("sum", "max" or "min") of ``t`` over the
    ranks of ``group``, in place and returned (``t`` itself when there is
    no group)."""
    if _traced("all_reduce", t) or not _live(group):
        return t
    import torch.distributed as dist

    t = t.contiguous()
    _note("all_reduce", _backend(group), t.numel() * t.element_size())
    dist.all_reduce(t, op=getattr(dist.ReduceOp, op.upper()), group=group)
    return t


def all_gather_rows(t: torch.Tensor, group, per: int, n: int) -> torch.Tensor:
    """The ``n`` rows of a table whose rank ``i`` (of ``group``) holds rows
    ``[i * per, i * per + len(t))`` as ``t``: every rank's block in rank
    order, along dim 0.  Blocks shorter than ``per`` (the last span) are
    padded for the call and the padding dropped."""
    if t.device.type == "meta":
        out = t.new_empty((int(n),) + tuple(t.shape[1:]))
        _traced("all_gather", out)
        return out
    if not _live(group):
        return t[:n]
    import torch.distributed as dist

    k = dist.get_world_size(group)
    rest = tuple(t.shape[1:])
    backend = _backend(group)
    part = t if t.shape[0] == per else torch.cat(
        [t, t.new_zeros((per - t.shape[0],) + rest)])
    part = part.contiguous()
    _note("all_gather", backend, part.numel() * part.element_size())
    if backend == "nccl":
        out = t.new_empty((k * per,) + rest)
        dist.all_gather_into_tensor(out, part, group=group)
    else:
        parts = [torch.empty_like(part) for _ in range(k)]
        dist.all_gather(parts, part, group=group)
        out = torch.cat(parts)
    return out[:n]


def broadcast(t: torch.Tensor, group, src: int = 0) -> torch.Tensor:
    """Group rank ``src``'s ``t`` on every rank of ``group`` (in place)."""
    if _traced("broadcast", t) or not _live(group):
        return t
    import torch.distributed as dist

    t = t.contiguous()
    _note("broadcast", _backend(group), t.numel() * t.element_size())
    dist.broadcast(t, group=group, group_src=src)
    return t


def ring_exchange(t: torch.Tensor, group) -> torch.Tensor:
    """One step of a ring over ``group``: send ``t`` to the next rank,
    return the previous rank's (the reference's ``ppermute`` by +1)."""
    if _traced("send_recv", t):
        return torch.empty_like(t)
    if not _live(group):
        return t
    import torch.distributed as dist

    k = dist.get_world_size(group)
    if k == 1:
        return t
    me = dist.get_rank(group)
    t = t.contiguous()
    out = torch.empty_like(t)
    backend = _backend(group)
    if backend != "nccl" and t.device.type == "cuda":
        # gloo sends no CUDA tensors: the step is a reduction of a zero
        # buffer each rank fills at its successor's slot
        buf = t.new_zeros((k,) + tuple(t.shape))
        buf[(me + 1) % k] = t
        _note("all_reduce", backend, buf.numel() * buf.element_size())
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=group)
        return buf[me].clone()
    _note("send_recv", backend, t.numel() * t.element_size())
    ranks = dist.get_process_group_ranks(group)
    ops = [dist.P2POp(dist.isend, t, ranks[(me + 1) % k], group=group),
           dist.P2POp(dist.irecv, out, ranks[(me - 1) % k], group=group)]
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out

