"""Device mesh and row placement — the distributed substrate (counterpart of
``transmogrifai_tpu/parallel/mesh.py``).

The reference is one process over all of a host's devices: XLA shards the row
blocks over the mesh's ``data`` axis and inserts the ``psum``s.  torch's idiom
is one process per card (``torchrun``), so the port maps the reference onto
ranks:

- a :class:`Mesh` is the (data, model) layout of the job's ranks, with one
  process group per row and column of the layout (made with the group
  timeout, so a rank that dies fails the others instead of hanging them),
  wrapped as a ``torch.distributed.device_mesh.DeviceMesh``;
- every rank runs the same host program on the whole host table; under
  :class:`use_mesh` a sharded family places only its rank's span of the rows
  on its card (:func:`place_rows`, :func:`row_span`), its row reductions
  cross the ``data`` group (``parallel/collectives.py``) and its grid points
  or folds split over the ``model`` group (:func:`model_share`);
- results are gathered back (:func:`gather_rows`, :func:`gather_model`), so
  every rank ends with the same fitted model and summary.

Spans are contiguous and follow the multi-host arithmetic
(``distributed.host_row_span``) over the UNPADDED rows: the reference pads to
a power-of-two bucket because XLA compiles one program per row count, and
torch's eager programs do not, so the port places real rows only and no
reduction needs a mask.  The reference's padding and bucket helpers
(:func:`pad_rows`, :func:`pad_rows_for_mesh`, :func:`bucket_size`,
:func:`pad_rows_to_bucket`, :func:`pad_rows_bucketed_for_mesh`,
:func:`row_mask`), its even split :func:`shard_rows` and its content-keyed
:func:`place_rows_bucketed_cached` are kept as the reference's public
names, so a script written against the reference imports and runs them; the
port's own paths do not call them.

The reference's ``constrain*`` layout hints have no torch meaning and are not
ported.
"""

from __future__ import annotations

import contextvars
import hashlib
import os
import threading
import warnings
import weakref
from datetime import timedelta
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from . import collectives as C

DATA_AXIS = "data"
MODEL_AXIS = "model"

#: seconds a collective may wait for a peer before the group fails
#: (``TMOG_GROUP_TIMEOUT_S``)
DEFAULT_GROUP_TIMEOUT_S = 300.0


def group_timeout() -> timedelta:
    return timedelta(seconds=float(os.environ.get(
        "TMOG_GROUP_TIMEOUT_S", DEFAULT_GROUP_TIMEOUT_S)))


def _dist_ready() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def device_count() -> int:
    """The job's ranks (one card each): the world size, 1 without a
    process group."""
    if not _dist_ready():
        return 1
    import torch.distributed as dist

    return dist.get_world_size()


def _local_ranks() -> int:
    if not _dist_ready():
        return 1
    import torch.distributed as dist

    return int(os.environ.get("LOCAL_WORLD_SIZE", dist.get_world_size()))


class Mesh:
    """A (data, model) layout of the job's ranks.

    ``devices`` is the (n_data, n_model) array of global ranks (model the
    fast axis), ``shape`` maps an axis to its size, ``group(axis)`` is this
    rank's process group along that axis (None in a one-process mesh, where
    every collective is the identity), ``index(axis)`` its coordinate there.
    ``device_type`` is where sharded work runs ("cuda" or "cpu") and
    ``backend`` the groups' backend, named when the mesh is made."""

    axis_names = (DATA_AXIS, MODEL_AXIS)

    def __init__(self, devices: np.ndarray, device_type: str,
                 groups: Optional[Dict[str, object]] = None,
                 backend: Optional[str] = None, device_mesh=None,
                 virtual: bool = False):
        self.devices = np.asarray(devices).reshape(
            np.asarray(devices).shape[0], -1)
        self.shape = {DATA_AXIS: int(self.devices.shape[0]),
                      MODEL_AXIS: int(self.devices.shape[1])}
        self.device_type = str(device_type)
        self.backend = backend
        self.device_mesh = device_mesh
        self._groups = groups
        #: a layout without processes (:func:`virtual_mesh`): static traces
        self.virtual = bool(virtual)
        #: ranks of the job and ranks on this host (the token's topology)
        self.world_size = int(self.devices.size) if virtual else device_count()
        self.local_ranks = int(self.devices.size) if virtual else _local_ranks()
        rank = 0
        if groups is not None:
            import torch.distributed as dist

            rank = dist.get_rank()
        pos = np.argwhere(self.devices == rank)
        if not len(pos):
            raise ValueError(f"rank {rank} is not in the mesh {self.devices.tolist()}")
        self._coord = {DATA_AXIS: int(pos[0][0]), MODEL_AXIS: int(pos[0][1])}
        self.rank = rank

    def group(self, axis: str, t: Optional[torch.Tensor] = None):
        """This rank's process group along ``axis``.  A virtual mesh has
        none, and runs collectives on meta operands only (``t``)."""
        if self.virtual and self.shape[axis] > 1 and \
                (t is None or t.device.type != "meta"):
            raise RuntimeError("a virtual mesh has no processes: it traces "
                               "programs on meta tensors only")
        return None if self._groups is None else self._groups[axis]

    def index(self, axis: str) -> int:
        return self._coord[axis]

    @property
    def device(self) -> torch.device:
        """This rank's device: its card (``torch.cuda.current_device()``,
        which ``distributed.initialize`` set from ``LOCAL_RANK``) or the CPU."""
        if self.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(self.device_type)

    def __repr__(self) -> str:
        return (f"Mesh(data={self.shape[DATA_AXIS]}, model={self.shape[MODEL_AXIS]}, "
                f"device_type={self.device_type!r}, backend={self.backend!r})")


def make_mesh(n_data: Optional[int] = None, n_model: int = 1,
              devices: Optional[Sequence[int]] = None,
              device_type: Optional[str] = None) -> Mesh:
    """A (data, model) mesh over the job's ranks.  Default: every rank on
    the data axis.  ``devices`` orders the global ranks (default
    ``range(world size)``); ``device_type`` defaults to the device the
    port's entry points resolve (the card unless ``use_device`` names
    another).  Under a process group every rank must make the same mesh,
    in the same order: making one is a collective (one group per row and
    column of the layout)."""
    devs = np.asarray(list(devices) if devices is not None
                      else range(device_count()), dtype=np.int64)
    total = devs.size
    if n_data is None:
        n_data = total // n_model
    if n_data * n_model != total:
        raise ValueError(f"mesh {n_data}x{n_model} != {total} devices")
    layout = devs.reshape(n_data, n_model)
    if device_type is None:
        from ..perf.kernels.dispatch import resolve_device

        device_type = resolve_device().type
    if not _dist_ready():
        if total != 1:
            raise ValueError(f"a mesh of {total} devices needs a process group "
                             f"of {total} ranks (distributed.initialize); "
                             "virtual_mesh traces a layout without one")
        return Mesh(layout, device_type)
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    if total != dist.get_world_size():
        raise ValueError(f"a mesh covers every rank: {total} != world size "
                         f"{dist.get_world_size()}")
    backend = str(dist.get_backend()).lower()
    timeout = group_timeout()
    me = dist.get_rank()
    groups: Dict[str, object] = {}
    for j in range(n_model):  # every rank makes every group, in one order
        g = dist.new_group([int(r) for r in layout[:, j]], timeout=timeout,
                           backend=backend)
        if me in layout[:, j]:
            groups[DATA_AXIS] = g
    for i in range(n_data):
        g = dist.new_group([int(r) for r in layout[i, :]], timeout=timeout,
                           backend=backend)
        if me in layout[i, :]:
            groups[MODEL_AXIS] = g
    dm = DeviceMesh.from_group([groups[DATA_AXIS], groups[MODEL_AXIS]],
                               device_type, mesh=torch.as_tensor(layout),
                               mesh_dim_names=(DATA_AXIS, MODEL_AXIS))
    return Mesh(layout, device_type, groups, backend, dm)


def virtual_mesh(n_data: int, n_model: int = 1, device_type: str = "meta") -> Mesh:
    """The (n_data, n_model) layout of a job of that many ranks as rank 0
    sees it, without processes: what static analysis traces a sharded
    program under (``checkers/plancheck.py`` counts its collectives on meta
    operands).  A collective on real tensors under it raises."""
    return Mesh(np.arange(int(n_data) * int(n_model)).reshape(n_data, n_model),
                device_type, virtual=True)


# --- ambient mesh context ----------------------------------------------------

_CURRENT_MESH: "contextvars.ContextVar[Optional[Mesh]]" = contextvars.ContextVar(
    "transmogrifai_tpu_torch_mesh", default=None)


class use_mesh:
    """Context manager: run workflow fits with row blocks sharded over `mesh`.

    >>> with use_mesh(make_mesh()):
    ...     model = workflow.train()
    """

    def __init__(self, mesh: Mesh):
        self.mesh = mesh
        self._token = None

    def __enter__(self) -> Mesh:
        self._token = _CURRENT_MESH.set(self.mesh)
        return self.mesh

    def __exit__(self, *exc) -> None:
        _CURRENT_MESH.reset(self._token)


def current_mesh() -> Optional[Mesh]:
    return _CURRENT_MESH.get()


def mesh_token(mesh: Optional[Mesh] = None) -> Optional[tuple]:
    """Hashable topology token of the ambient (or given) mesh: the axis
    names, the axis sizes, the world size, the ranks on this host and the
    backend; None without a mesh.  Every plan fingerprint, sweep journal key
    and deploy manifest carries it, so a meshed program never aliases an
    unmeshed one, nor one of another topology."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        return None
    return (tuple(mesh.axis_names),
            tuple(int(mesh.shape[a]) for a in mesh.axis_names),
            mesh.world_size, mesh.local_ranks, mesh.backend)


# --- padding and buckets (the reference's arithmetic, copied) ----------------

def pad_axis(arr: np.ndarray, axis: int, multiple: int) -> Tuple[np.ndarray, int]:
    """Zero-pad one axis to a multiple (sharding needs even splits);
    returns (padded, n_valid along that axis)."""
    n = arr.shape[axis]
    rem = (-n) % multiple
    if rem == 0:
        return arr, n
    pad_width = [(0, 0)] * arr.ndim
    pad_width[axis] = (0, rem)
    return np.pad(arr, pad_width), n


def pad_rows(arr: np.ndarray, multiple: int) -> Tuple[np.ndarray, int]:
    """Pad rows to a multiple; returns (padded, n_valid)."""
    return pad_axis(arr, 0, multiple)


def pad_rows_for_mesh(*arrays, mesh: Optional[Mesh] = None):
    """Zero-pad the leading axis of each array to the mesh's data-axis
    multiple.  Returns (padded_arrays..., n_valid); a no-op without a mesh."""
    mesh = mesh if mesh is not None else current_mesh()
    first = np.asarray(arrays[0])
    if mesh is None:
        return (*arrays, first.shape[0])
    mult = mesh.shape[DATA_AXIS]
    out = [pad_axis(np.asarray(a), 0, mult)[0] for a in arrays]
    return (*out, first.shape[0])


def bucket_size(n: int, minimum: int = 1024) -> int:
    """Next power-of-two row count (at least ``minimum``)."""
    n = int(n)
    if n <= minimum:
        return minimum
    return 1 << (n - 1).bit_length()


def pad_rows_to_bucket(n: int, *arrays):
    """Zero-pad each array's leading axis from n to bucket_size(n)."""
    m = bucket_size(n)
    if m == n:
        return arrays
    return tuple(pad_axis(np.asarray(a), 0, m)[0] for a in arrays)


def pad_rows_bucketed_for_mesh(*arrays, n: Optional[int] = None):
    """Bucket-pad then mesh-pad leading axes (that order — bucket sizes are
    powers of two, so the mesh multiple keeps dividing them); returns
    (*padded, n_valid)."""
    n_valid = int(arrays[0].shape[0] if n is None else n)
    bucketed = pad_rows_to_bucket(n_valid, *arrays)
    return pad_rows_for_mesh(*bucketed)[:-1] + (n_valid,)


def row_mask(n_padded: int, n_valid: int, device=None) -> torch.Tensor:
    """float32 1 for a valid row, 0 for a padded one."""
    return (torch.arange(n_padded, device=device) < n_valid).to(torch.float32)


# --- spans and placement -----------------------------------------------------

def _resolve(device) -> torch.device:
    from ..perf.kernels.dispatch import resolve_device

    return resolve_device(device)


def row_span(n: int, mesh: Optional[Mesh] = None) -> slice:
    """The contiguous rows of an ``n``-row table this rank holds: its
    ``data`` coordinate's span (``distributed.host_row_span``), every row
    without a mesh."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None:
        return slice(0, int(n))
    from .distributed import host_row_span

    return host_row_span(int(n), mesh.index(DATA_AXIS), mesh.shape[DATA_AXIS])


def shard_rows(arr: np.ndarray, mesh: Optional[Mesh] = None, device=None):
    """This rank's block of ``arr`` padded to the data-axis multiple (the
    reference's even split) on its device; returns (block, n_valid_rows).
    Callers mask with :func:`row_mask` so padded rows never contaminate
    statistics."""
    dev = _resolve(device)
    arr = np.asarray(arr)
    if mesh is None:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(dev), arr.shape[0]
    k = mesh.shape[DATA_AXIS]
    padded, n_valid = pad_rows(arr, k)
    per = padded.shape[0] // k
    i = mesh.index(DATA_AXIS)
    block = np.ascontiguousarray(padded[i * per:(i + 1) * per])
    return torch.from_numpy(block).to(dev), n_valid


def _span_block(arr: np.ndarray, mesh: Optional[Mesh], axis: int,
                device: torch.device) -> torch.Tensor:
    """``mesh``'s rank's span of ``arr`` along ``axis`` on ``device`` (the
    whole array when ``mesh`` is None: no ambient lookup here)."""
    if mesh is not None:
        sl = [slice(None)] * arr.ndim
        sl[axis] = row_span(arr.shape[axis], mesh)
        arr = arr[tuple(sl)]
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:
        # a frozen source (the stamp memo's): a CPU tensor must not alias it,
        # and a copy to the card reads it once
        if device.type == "cpu":
            return torch.from_numpy(arr.copy())
        with warnings.catch_warnings():
            warnings.simplefilter("ignore", UserWarning)
            return torch.from_numpy(arr).to(device)
    return torch.from_numpy(arr).to(device)


def place_rows(arr, mesh: Optional[Mesh] = None, device=None) -> torch.Tensor:
    """This rank's span (:func:`row_span`) of ``arr``'s rows on its device;
    the whole block without a mesh.  Uneven row counts are fine."""
    mesh = mesh if mesh is not None else current_mesh()
    return _span_block(np.asarray(arr), mesh, 0, _resolve(device))


def _effective_spec(shape, axes, mesh: Mesh) -> tuple:
    """The one degradation rule: an axis the mesh does not know, or whose
    dimension does not divide by the axis's size, degrades to replication
    (a 1-point grid over a 2-way model axis must still run)."""
    return tuple(
        a if (a in mesh.axis_names and i < len(shape)
              and int(shape[i]) % int(mesh.shape[a]) == 0)
        else None
        for i, a in enumerate(axes))


def place(arr, axes: Tuple[Optional[str], ...], mesh: Optional[Mesh] = None,
          device=None) -> torch.Tensor:
    """This rank's block of ``arr`` under the partition ``axes`` (a mesh axis
    or None per dimension) on its device: an even split along each axis
    that divides, the whole dimension elsewhere (:func:`_effective_spec`);
    the whole array without a mesh.  A tensor input is split on its own
    device."""
    mesh = mesh if mesh is not None else current_mesh()
    t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(np.asarray(arr)))
    dev = t.device if isinstance(arr, torch.Tensor) and device is None \
        else _resolve(device)
    if mesh is not None:
        for dim, a in enumerate(_effective_spec(t.shape, axes, mesh)):
            if a is None:
                continue
            per = t.shape[dim] // mesh.shape[a]
            t = t.narrow(dim, mesh.index(a) * per, per)
    return t.contiguous().to(dev)


def model_share(count: int, mesh: Optional[Mesh] = None) -> list:
    """The indices of ``count`` grid points (or folds) this rank's model
    coordinate fits: a contiguous block of an even split, every index when
    the model axis does not divide ``count`` or there is no mesh (the
    :func:`_effective_spec` rule)."""
    mesh = mesh if mesh is not None else current_mesh()
    if mesh is None or count % mesh.shape[MODEL_AXIS] != 0 \
            or mesh.shape[MODEL_AXIS] == 1:
        return list(range(count))
    per = count // mesh.shape[MODEL_AXIS]
    lo = mesh.index(MODEL_AXIS) * per
    return list(range(lo, lo + per))


def gather_model(t: torch.Tensor, index: Sequence[int], total: int,
                 mesh: Optional[Mesh] = None, dim: int = 0) -> torch.Tensor:
    """The ``total`` slices along ``dim`` of which this rank holds ``index``
    (from :func:`model_share`), from every rank of the ``model`` group:
    a zero buffer each rank fills at its indices, summed over the group
    (exact).  ``t`` itself when it holds every index."""
    mesh = mesh if mesh is not None else current_mesh()
    if len(index) == total:
        return t
    t = t.movedim(dim, 0)
    buf = t.new_zeros((total,) + tuple(t.shape[1:]))
    buf[torch.as_tensor(list(index), device=t.device)] = t
    return C.all_reduce(buf, mesh.group(MODEL_AXIS, buf)).movedim(0, dim)


def gather_rows(t: torch.Tensor, n: int, mesh: Optional[Mesh] = None,
                dim: int = 0) -> torch.Tensor:
    """The ``n`` rows (along ``dim``) of a table this rank holds its span of,
    in the table's row order, from every rank of the ``data`` group."""
    mesh = mesh if mesh is not None else current_mesh()
    if not sharded(mesh):
        return t
    per = -(-int(n) // mesh.shape[DATA_AXIS])
    out = C.all_gather_rows(t.movedim(dim, 0), mesh.group(DATA_AXIS, t), per, int(n))
    return out.movedim(0, dim)


def reduce_rows(t: torch.Tensor, mesh: Optional[Mesh] = None) -> torch.Tensor:
    """The sum of ``t`` (a reduction over this rank's rows) over the
    ``data`` group: the reference's ``psum``.  ``t`` without a mesh."""
    mesh = mesh if mesh is not None else current_mesh()
    if not sharded(mesh):
        return t
    return C.all_reduce(t, mesh.group(DATA_AXIS, t))


def sharded(mesh: Optional[Mesh] = None) -> bool:
    """True when a mesh's ``data`` axis takes the sharded path: it splits
    the rows over more than one rank, or it is a process group's (a
    one-rank group too: its reductions are real collectives, as a job's
    are)."""
    mesh = mesh if mesh is not None else current_mesh()
    return mesh is not None and (mesh.shape[DATA_AXIS] > 1
                                 or mesh._groups is not None)


# --- shared device placement cache (the reference's, copied) -----------------
# One selector fit runs several families over the SAME operands.  The small
# ones (labels, weights, fold weights) are re-materialised as fresh float32
# copies per family, so their cache keys on a CONTENT fingerprint (shape +
# dtype + full-buffer blake2b) and an identical copy still hits.  The
# feature block is one array the families share: it keys on that array's
# identity (:func:`place_block_cached`), so placing it again costs no pass
# over its bytes.  Bounded FIFOs: entries survive their source array, old
# blocks roll off so device memory stays bounded.
_PLACED_ROWS_CACHE: dict = {}
_PLACED_ROWS_CACHE_MAX = 3
_PLACED_AUX_CACHE: dict = {}
_PLACED_AUX_CACHE_MAX = 8

#: one lock for the stamp memo and both placement FIFOs; the device copies
#: run outside it (a double-place on a concurrent miss is benign)
_PLACEMENT_LOCK = threading.RLock()

_STAMP_MEMO: dict = {}
_STAMP_MEMO_MAX = 16
#: only blocks whose full hash is expensive are worth a memo slot
_STAMP_MEMO_MIN_BYTES = 64 * 1024 * 1024


def _quick_sig(a: np.ndarray) -> bytes:
    """Cheap strided sub-sample hash used ONLY to validate memo hits (64
    evenly strided 4 KB windows and the tail); the authoritative stamp is
    the full hash."""
    flat = np.frombuffer(memoryview(a).cast("B"), dtype=np.uint8)
    n = flat.shape[0]
    h = hashlib.blake2b(digest_size=8)
    win = 4096
    stride = max(n // 64, 1)
    for start in range(0, n, stride):
        h.update(memoryview(flat[start:start + win]))
    h.update(memoryview(flat[max(n - win, 0):]))
    return h.digest()


def _content_stamp(a: np.ndarray) -> bytes:
    """Full-buffer blake2b-128 content fingerprint.

    Memoized per source object for LARGE owner blocks only, through a weak
    reference; a memoized array is FROZEN (``writeable=False``), so an
    in-place mutation of a cached placement source raises instead of
    serving stale device data (re-enabling ``writeable`` opts out: a
    writeable array never hits the memo).  VIEWS (any array with a base)
    are never memoized or frozen.  A hit needs the owner still frozen, the
    same (shape, dtype) and the same strided signature."""
    contiguous = a.flags["C_CONTIGUOUS"]
    memoizable = contiguous and a.nbytes >= _STAMP_MEMO_MIN_BYTES
    if memoizable:
        memo_key = id(a)
        with _PLACEMENT_LOCK:
            hit = _STAMP_MEMO.get(memo_key)
        frozen_ok = a.base is None and not a.flags.writeable
        if hit is not None and hit[0]() is a and frozen_ok \
                and hit[1] == (a.shape, a.dtype.str) \
                and hit[2] == _quick_sig(a):
            return hit[3]
    raw = a if contiguous else np.ascontiguousarray(a)
    stamp = hashlib.blake2b(memoryview(raw).cast("B"), digest_size=16).digest()
    if memoizable and a.base is None:
        with _PLACEMENT_LOCK:
            try:
                ref = weakref.ref(a)  # before the freeze (see the reference)
                was_writeable = bool(a.flags.writeable)
                a.flags.writeable = False
                _STAMP_MEMO[memo_key] = (ref, (a.shape, a.dtype.str),
                                         _quick_sig(a), stamp, was_writeable)
            except (TypeError, ValueError):
                pass  # weakref-refusing subclass / flag-locked array: no memo
            for k in [k for k, v in _STAMP_MEMO.items() if v[0]() is None]:
                _STAMP_MEMO.pop(k)
            while len(_STAMP_MEMO) > _STAMP_MEMO_MAX:
                _evict_stamp(next(iter(_STAMP_MEMO)))
    return stamp


def _evict_stamp(key) -> None:
    """Drop a memo entry and lift its freeze (only if the memo froze it)."""
    with _PLACEMENT_LOCK:
        entry = _STAMP_MEMO.pop(key, None)
    if entry is not None:
        arr = entry[0]()
        if arr is not None and entry[4]:
            try:
                arr.flags.writeable = True
            except ValueError:
                pass


def _cached(cache: dict, cap: int, key, make, insert: bool = True):
    with _PLACEMENT_LOCK:
        hit = cache.pop(key, None)
        if hit is not None:
            cache[key] = hit  # LRU: a hit re-inserts at the back
            return hit
    value = make()
    if insert:
        with _PLACEMENT_LOCK:
            cache[key] = value
            while len(cache) > cap:
                cache.pop(next(iter(cache)))
    return value


def place_cached(arr, axes: tuple, mesh: Optional[Mesh] = None,
                 device=None) -> torch.Tensor:
    """:func:`place` with the content-keyed dedup: (shape, dtype, blake2b,
    axes, mesh, device), a bounded FIFO.  ``axes=()`` is a replicated
    placement (the whole array on this rank's device)."""
    mesh = mesh if mesh is not None else current_mesh()
    arr = np.asarray(arr)
    dev = _resolve(device)
    key = (arr.shape, str(arr.dtype), _content_stamp(arr), tuple(axes), mesh,
           str(dev))
    return _cached(_PLACED_AUX_CACHE, _PLACED_AUX_CACHE_MAX, key,
                   lambda: place(arr, tuple(axes), mesh=mesh, device=dev))


def place_rows_cached(arr, row_axis: int = 0, mesh: Optional[Mesh] = None,
                      device=None) -> torch.Tensor:
    """This rank's span of ``arr`` along ``row_axis`` (``(k, n)`` fold
    weights: 1) on its device, content-cached like :func:`place_cached`."""
    mesh = mesh if mesh is not None else current_mesh()
    arr = np.asarray(arr)
    dev = _resolve(device)
    key = (arr.shape, str(arr.dtype), _content_stamp(arr), ("rows", row_axis),
           mesh, str(dev))

    return _cached(_PLACED_AUX_CACHE, _PLACED_AUX_CACHE_MAX, key,
                   lambda: _span_block(arr, mesh, row_axis, dev))


def place_rows_bucketed_cached(arr, mesh: Optional[Mesh] = None,
                               insert: bool = True, device=None,
                               replicate: bool = False):
    """(this rank's rows of ``arr`` on its device, n_valid), cached on a
    content fingerprint of the source block, so repeated placements of the
    same data (even a fresh equal-valued copy) are free.  The rows are
    unpadded (the module's note on buckets).

    ``insert=False`` is the serving-path mode: it HITS the cache but a miss
    places without inserting, so chunked scoring of a large table does not
    churn the fit block out of the small FIFO.  ``replicate`` places every
    row on this rank (a family the mesh does not shard)."""
    mesh = None if replicate else (mesh if mesh is not None else current_mesh())
    arr = np.asarray(arr)
    dev = _resolve(device)
    key = (arr.shape, str(arr.dtype), _content_stamp(arr), mesh, str(dev))
    return _cached(_PLACED_ROWS_CACHE, _PLACED_ROWS_CACHE_MAX, key,
                   lambda: (_span_block(arr, mesh, 0, dev), arr.shape[0]),
                   insert=insert)


def _row_sample(a: np.ndarray) -> int:
    """A hash of 64 evenly strided rows: an in-place change of one of them
    turns an identity hit into a miss (the sampled check the identity key
    adds; the full-content check is :func:`_content_stamp`'s)."""
    return hash(a[::max(1, a.shape[0] // 64)].tobytes())


def place_block_cached(arr: np.ndarray, mesh: Optional[Mesh] = None,
                       insert: bool = True, device=None,
                       replicate: bool = False) -> torch.Tensor:
    """This rank's rows of the feature block ``arr`` on its device (every
    row when ``replicate`` or without a mesh), cached on the block's
    identity: (the array, its shape, dtype and :func:`_row_sample`, the
    mesh, the device).  The entry holds the array, so its id is not reused
    while the entry lives.  A fresh equal copy places anew; the small
    operands that are re-made per family go through the content-keyed
    :func:`place_rows_cached` / :func:`place_cached` instead.
    ``insert=False`` (a scoring call) hits but does not insert."""
    mesh = None if replicate else (mesh if mesh is not None else current_mesh())
    dev = _resolve(device)
    key = ("block", id(arr), arr.shape, arr.dtype.str, _row_sample(arr), mesh,
           str(dev))
    return _cached(_PLACED_ROWS_CACHE, _PLACED_ROWS_CACHE_MAX, key,
                   lambda: (arr, _span_block(arr, mesh, 0, dev)), insert=insert)[1]
