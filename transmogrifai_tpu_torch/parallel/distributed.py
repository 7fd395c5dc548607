"""Multi-process initialization and mesh construction (counterpart of
``transmogrifai_tpu/parallel/distributed.py``).

The reference bootstraps ``jax.distributed``, one process per host.  The
port runs one process per card under ``torchrun`` (or any launcher that sets
its variables), joined by a ``torch.distributed`` process group: NCCL on the
card, gloo where the caller names the CPU.

Usage (one process per card, e.g. ``torchrun --nproc-per-node 4 train.py``):

    from transmogrifai_tpu_torch.parallel import distributed
    distributed.initialize()                # torchrun's environment
    mesh = distributed.global_mesh(n_model=2)
    with use_mesh(mesh):
        model = workflow.train()
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Sequence

import numpy as np
import torch

from .mesh import (DATA_AXIS, MODEL_AXIS, current_mesh, device_count,
                   group_timeout, make_mesh, place_rows)

log = logging.getLogger(__name__)


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None,
               backend: Optional[str] = None) -> None:
    """Join the job's process group (idempotent).

    The arguments come from the caller or from ``torchrun``'s environment
    (``MASTER_ADDR``/``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``); a
    ``coordinator_address`` is ``host:port``, or a full init method
    (``tcp://``, ``file://``).  One process with nothing to join is a
    no-op.  The backend is NCCL on the card and gloo when the entry points
    resolve the CPU (``use_device("cpu")``), unless ``backend`` names one.
    On the card each process takes the card ``LOCAL_RANK`` names
    (``torch.cuda.set_device``), so the entry points under a mesh give each
    rank its own card.  The group carries the group timeout
    (``TMOG_GROUP_TIMEOUT_S``): a rank that dies fails the others' next
    collective instead of hanging them."""
    import torch.distributed as dist

    if is_initialized():
        return
    env = os.environ
    if coordinator_address is None and "MASTER_ADDR" in env:
        coordinator_address = f"{env['MASTER_ADDR']}:{env.get('MASTER_PORT', '29500')}"
    if num_processes is None and "WORLD_SIZE" in env:
        num_processes = int(env["WORLD_SIZE"])
    if process_id is None and "RANK" in env:
        process_id = int(env["RANK"])
    explicit = coordinator_address is not None or num_processes is not None \
        or process_id is not None
    if not explicit and not _pod_environment():
        return  # one process, nothing to join
    if coordinator_address is None or num_processes is None or process_id is None:
        n_implied = _implied_worker_count()
        missing = ("coordinator_address/num_processes/process_id are not all "
                   "given or in the environment")
        if n_implied > 1 or explicit:
            raise RuntimeError(
                f"process-group bootstrap failed ({missing}) but environment "
                f"markers imply {n_implied} workers; refusing to continue as "
                "a single-process run. Pass coordinator_address/"
                "num_processes/process_id explicitly.")
        log.warning("process-group bootstrap skipped (%s); continuing as a "
                    "single-process run. If this IS a multi-process job, pass "
                    "coordinator_address/num_processes/process_id explicitly.",
                    missing)
        return
    from ..perf.kernels.dispatch import resolve_device

    dev_type = resolve_device().type
    backend = backend or ("nccl" if dev_type == "cuda" else "gloo")
    if dev_type == "cuda":
        torch.cuda.set_device(int(env.get("LOCAL_RANK", "0")))
    init = coordinator_address if "://" in coordinator_address \
        else f"tcp://{coordinator_address}"
    dist.init_process_group(backend=backend, init_method=init,
                            world_size=int(num_processes), rank=int(process_id),
                            timeout=group_timeout())


def _implied_worker_count() -> int:
    """Worker count the launcher markers imply; 1 when ambiguous/absent
    (the reference's markers plus torchrun's ``WORLD_SIZE``)."""
    hosts = os.environ.get("TPU_WORKER_HOSTNAMES", "")
    counts = [len([h for h in hosts.split(",") if h.strip()])]
    for var in ("SLURM_JOB_NUM_NODES", "OMPI_COMM_WORLD_SIZE", "WORLD_SIZE"):
        try:
            counts.append(int(os.environ.get(var, "1")))
        except ValueError:
            pass
    for var in ("TPU_WORKER_ID", "CLOUD_TPU_TASK_ID"):
        try:
            counts.append(int(os.environ.get(var, "-1")) + 1)
        except ValueError:
            pass
    if os.environ.get("MEGASCALE_COORDINATOR_ADDRESS"):
        counts.append(2)
    return max(counts + [1])


def _pod_environment() -> bool:
    """Multi-process launcher markers."""
    return any(v in os.environ for v in (
        "TPU_WORKER_HOSTNAMES", "CLOUD_TPU_TASK_ID", "MEGASCALE_COORDINATOR_ADDRESS",
        "TPU_WORKER_ID", "SLURM_JOB_NUM_NODES", "OMPI_COMM_WORLD_SIZE",
        "WORLD_SIZE"))


def is_initialized() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized()


def _rank() -> int:
    import torch.distributed as dist

    return dist.get_rank() if is_initialized() else 0


def _platform() -> str:
    from ..perf.kernels.dispatch import resolve_device

    try:
        return resolve_device().type
    except RuntimeError:
        return "cpu"


def process_info() -> dict:
    """Topology summary for logs and metrics (the reference's keys)."""
    return {
        "processId": _rank(),
        "processCount": device_count(),
        "localDevices": 1,
        "globalDevices": device_count(),
        "platform": _platform(),
    }


def _host_of(rank: int) -> int:
    per_host = int(os.environ.get("LOCAL_WORLD_SIZE", device_count()))
    return int(rank) // max(per_host, 1)


def global_mesh(n_model: int = 1, devices: Optional[Sequence] = None,
                strict_topology: bool = True):
    """A (data, model) dp x mp mesh over every rank of the job.

    Ranks are host-major (torchrun numbers a host's ranks consecutively), so
    the data axis splits contiguously across hosts, and the model axis is
    the fast one: with ``n_model`` dividing the ranks on a host, every model
    group lives on one host and its gathers never cross the network.  A
    model group that would span hosts raises (``strict_topology=False``
    downgrades it to a warning).  ``devices`` may name the ranks in order,
    as ints or as objects with a ``process_index`` (a host id)."""
    devs = list(devices) if devices is not None else list(range(device_count()))
    n_model = int(n_model)
    if n_model < 1 or len(devs) % n_model != 0:
        raise ValueError(
            f"n_model={n_model} must divide the {len(devs)} global devices")

    def host(d):
        return getattr(d, "process_index", None) if not isinstance(d, (int, np.integer)) \
            else _host_of(int(d))

    crossing = n_model > 1 and any(
        len({host(d) for d in devs[i:i + n_model]}) > 1
        for i in range(0, len(devs), n_model))
    if crossing:
        msg = (f"a model-parallel group of {n_model} devices would span "
               f"hosts and its gathers would cross the network; pick n_model "
               f"so each group of {n_model} consecutive devices lives on one "
               f"process")
        if strict_topology:
            raise ValueError(msg)
        log.warning("%s (continuing: strict_topology=False)", msg)
    if not all(isinstance(d, (int, np.integer)) for d in devs):
        devs = list(range(len(devs)))
    return make_mesh(n_data=len(devs) // n_model, n_model=n_model, devices=devs)


def mesh_topology(mesh=None) -> dict:
    """Self-describing topology block for provenance: the mesh factoring
    plus the process layout it rides on."""
    mesh = mesh if mesh is not None else current_mesh()
    out = {
        "processCount": device_count(),
        "processIndex": _rank(),
        "localDevices": 1,
        "globalDevices": device_count(),
        "platform": _platform(),
    }
    if mesh is not None:
        out["meshShape"] = {a: int(mesh.shape[a]) for a in mesh.axis_names}
        out["dp"], out["mp"] = int(mesh.shape[DATA_AXIS]), int(mesh.shape[MODEL_AXIS])
        out["backend"] = mesh.backend
    return out


def host_local_rows(n_global_rows: int) -> slice:
    """This process's contiguous row range for sharded ingest."""
    return host_row_span(n_global_rows, _rank(), device_count())


def host_row_span(n_global_rows: int, process_id: int,
                  process_count: int) -> slice:
    """The contiguous row range process ``process_id`` of ``process_count``
    owns (the reference's arithmetic, copied)."""
    per = -(-int(n_global_rows) // int(process_count))
    start = min(int(process_id) * per, int(n_global_rows))
    return slice(start, min(start + per, int(n_global_rows)))


def host_row_spans(n_global_rows: int,
                   process_count: Optional[int] = None) -> list:
    """Every process's row span, in process order: they partition
    ``range(n_global_rows)`` exactly."""
    pc = device_count() if process_count is None else int(process_count)
    return [host_row_span(n_global_rows, pid, pc) for pid in range(pc)]


def global_row_array(local_rows, n_global_rows: Optional[int] = None,
                     mesh=None) -> torch.Tensor:
    """This rank's rows of a global row-sharded table, from the block this
    process decoded.

    ``local_rows`` holds exactly this process's ``host_local_rows(n_global)``
    slice (each process decodes only its own span).  Under a mesh whose
    data axis is every process, that block IS this rank's share and is
    placed as is; one process (or no mesh) places the whole table through
    :func:`~.mesh.place_rows` and refuses a partial block."""
    mesh = mesh if mesh is not None else current_mesh()
    local = np.asarray(local_rows)
    n_global = int(n_global_rows) if n_global_rows is not None \
        else local.shape[0]
    if mesh is None or device_count() == 1:
        if local.shape[0] != n_global:
            raise ValueError(
                f"single-process assembly expects the full {n_global} rows, "
                f"got {local.shape[0]} (host_local_rows of one process is "
                f"the whole table)")
        return place_rows(local, mesh)
    span = host_local_rows(n_global)
    if local.shape[0] != span.stop - span.start:
        raise ValueError(
            f"process {_rank()} owns rows [{span.start}, {span.stop}) of "
            f"{n_global} but got a {local.shape[0]}-row block; decode exactly "
            f"host_local_rows(n_global)")
    if mesh.shape[DATA_AXIS] != device_count():
        raise ValueError("a process-local block is a rank's share only on a "
                         "mesh whose data axis is every process")
    return torch.from_numpy(np.ascontiguousarray(local)).to(mesh.device)
