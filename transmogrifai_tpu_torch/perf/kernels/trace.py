"""The hand-written kernels as nodes of a meta trace.

The kernels launch through ctypes, so a ``TorchDispatchMode`` that traces a
program on ``torch.device("meta")`` operands never sees them.  Each wrapper
(``encode.encode_slots``, ``histogram.hist_level``,
``splitscan.split_scan``, ``routing.row_select_lanes``) therefore takes a
meta branch of its own: it checks its operands as a launch would, makes its
outputs as meta tensors and calls :func:`record`, which hands every active
sink (``checkers/plancheck.py``'s cost trace, ``checkers/irsnap.py``'s graph
capture) a :class:`KernelNode`.  Nothing is launched, allocated or built,
and no launch counter moves.  While a sink is open, a launch on the card
records the same node (``active`` is the one integer a launch reads to
know), so a capture of a program run on CUDA operands reads as its meta
capture.

A node holds the kernel's name, its operands' and results' shapes and
dtypes, its default launch plan (each module's ``plan`` rules, not the
autotuner's winner: the winner is a property of the card, the trace of the
program), the FLOPs and bytes of the kernel's own ``bound_ops`` /
``bound_bytes``, and the host decisions a launch would take from the data
(K1's int8-or-float path and its sum bound), which a meta run takes as
arguments instead.
"""

from __future__ import annotations

import threading
from contextlib import contextmanager
from typing import Any, Dict, List, NamedTuple, Sequence, Tuple

import torch


class KernelNode(NamedTuple):
    """One kernel call of a meta trace."""

    name: str
    inputs: Tuple[Tuple[Tuple[int, ...], str], ...]
    outputs: Tuple[Tuple[Tuple[int, ...], str], ...]
    plan: Dict[str, Any]
    flops: int
    bytes: int
    decisions: Dict[str, Any]

    def to_dict(self) -> Dict[str, Any]:
        return {"name": self.name,
                "inputs": [[list(s), d] for s, d in self.inputs],
                "outputs": [[list(s), d] for s, d in self.outputs],
                "plan": dict(self.plan), "flops": int(self.flops),
                "bytes": int(self.bytes), "decisions": dict(self.decisions)}


_state = threading.local()
#: sinks open on any thread: the launch paths read this one integer and
#: record a node only while a capture is open (``checkers/irsnap.py``
#: captures the card's run of a family)
active = 0
_active_lock = threading.Lock()


def _sinks() -> List[Any]:
    sinks = getattr(_state, "sinks", None)
    if sinks is None:
        sinks = _state.sinks = []
    return sinks


@contextmanager
def sink(obj):
    """Make ``obj`` (anything with a ``kernel(node, inputs, outputs)``
    method) receive the kernel nodes recorded on this thread while the
    block runs."""
    global active
    sinks = _sinks()
    sinks.append(obj)
    with _active_lock:
        active += 1
    try:
        yield obj
    finally:
        sinks.remove(obj)
        with _active_lock:
            active -= 1


def _sig(ts: Sequence[torch.Tensor]):
    return tuple((tuple(int(s) for s in t.shape), str(t.dtype).replace("torch.", ""))
                 for t in ts)


def record_collective(op: str, nbytes: int) -> None:
    """Hand a collective of a meta trace (``parallel/collectives.py``: an
    operation on meta operands runs nothing) to every active sink of this
    thread that counts collectives."""
    for s in list(_sinks()):
        hook = getattr(s, "collective", None)
        if hook is not None:
            hook(op, int(nbytes))


def record(name: str, inputs: Sequence[torch.Tensor], outputs: Sequence[torch.Tensor],
           plan: Dict[str, Any], flops: int, nbytes: int, **decisions) -> None:
    """Hand a kernel node to every active sink of this thread."""
    sinks = _sinks()
    if not sinks:
        return
    node = KernelNode(name, _sig(inputs), _sig(outputs), dict(plan), int(flops),
                      int(nbytes), dict(decisions))
    for s in list(sinks):
        s.kernel(node, list(inputs), list(outputs))
