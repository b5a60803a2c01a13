"""Multi-process execution over ``torch.distributed``.

Counterpart of ``raystrack_tpu/parallel/multihost.py``, which brings up the
JAX distributed runtime. The scale-out model has the same two layers:

- inside a process, rays split over its devices (``mesh=``,
  ``parallel.sharding``), integer counts summed: bitwise exact;
- across processes, whole emitters: each process solves a deterministic
  emitter partition (``parallel.distribute``), and the per-process row
  dicts are exchanged and merged so every process ends with the identical
  full matrix.

:func:`initialize` joins the process group (``torchrun`` fills in its
environment; else pass the coordinator's address, the process count and
this process's rank). The only data that crosses processes is row dicts of
a few KB, exchanged as bytes in CPU tensors over the ``gloo`` backend: no
NCCL, so several processes may share one card.

Runbook (a node of N cards, one process a card)::

    torchrun --nproc-per-node=N solve.py

where ``solve.py`` calls ``initialize()`` and then
``view_factor_matrix_multihost(meshes, params)``; each process binds the
card ``LOCAL_RANK % device_count`` and every process returns the merged
dict. Across hosts, run the same on each with ``--nnodes``,
``--node-rank`` and ``--rdzv-endpoint`` (torchrun's own flags).
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..params import MatrixParams
from ..prepared import PreparedSolver
from .distribute import (
    view_factor_matrix_partition,
    view_factor_sky_partition,
    view_factor_workflow_partition,
)

Mesh = Tuple[str, np.ndarray, np.ndarray]
VFDict = Dict[str, Dict[str, float]]


def _process() -> Tuple[int, int]:
    """(rank, world size) of this process: (0, 1) outside a process group."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    return 0, 1


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    **kwargs,
) -> Tuple[int, int]:
    """Join the ``torch.distributed`` process group; returns (rank, count).

    With ``coordinator_address`` (``host:port``, or an ``init_method`` URL),
    ``num_processes`` and ``process_id`` the group starts on the ``gloo``
    backend at that address. Without them it reads torch's own environment
    (``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, as
    ``torchrun`` sets them). With neither the process runs alone: it
    returns ``(0, 1)`` and starts no group. A group already started is kept.
    ``kwargs`` go to ``init_process_group``.

    Where a card is present, the process binds the card ``LOCAL_RANK %
    device_count`` (its rank without ``LOCAL_RANK``): a JAX process sees
    only its own devices, a torch process sees them all and would
    otherwise take ``cuda:0``.
    """
    import torch.distributed as dist

    if not dist.is_available():
        return 0, 1
    explicit = (coordinator_address, num_processes, process_id)
    from_env = all(k in os.environ for k in ("MASTER_ADDR", "RANK", "WORLD_SIZE"))
    if not dist.is_initialized():
        if any(v is not None for v in explicit):
            if any(v is None for v in explicit):
                raise ValueError("coordinator_address, num_processes and process_id go "
                                 "together")
            url = (coordinator_address if "://" in coordinator_address
                   else f"tcp://{coordinator_address}")
            dist.init_process_group("gloo", init_method=url, world_size=int(num_processes),
                                    rank=int(process_id), **kwargs)
        elif from_env:
            dist.init_process_group("gloo", init_method="env://", **kwargs)
        else:
            return 0, 1
    rank, count = _process()
    if torch.cuda.is_available():
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", rank))
                              % torch.cuda.device_count())
    return rank, count


def _exchange_rows(local: VFDict) -> List[VFDict]:
    """All-gather per-process row dicts.

    Dicts ride as length-prefixed JSON bytes in a padded uint8 CPU tensor;
    a first all-gather agrees on the buffer size. Every process receives
    every partition, so the merge is replicated and deterministic.
    """
    import torch.distributed as dist

    _, count = _process()
    if count == 1:
        return [local]
    payload = torch.frombuffer(
        bytearray(json.dumps(local, sort_keys=True).encode("utf-8")), dtype=torch.uint8)
    sizes = [torch.zeros(1, dtype=torch.int64) for _ in range(count)]
    dist.all_gather(sizes, torch.tensor([payload.numel()], dtype=torch.int64))
    width = max(int(s) for s in sizes)
    buf = torch.zeros(width, dtype=torch.uint8)
    buf[: payload.numel()] = payload
    gathered = [torch.empty(width, dtype=torch.uint8) for _ in range(count)]
    dist.all_gather(gathered, buf)
    return [json.loads(bytes(g[: int(s)].numpy()).decode("utf-8"))
            for g, s in zip(gathered, sizes)]


def view_factor_matrix_multihost(
    meshes: List[Mesh],
    params: MatrixParams,
    *,
    prepared: Optional[PreparedSolver] = None,
    mesh=None,
) -> VFDict:
    """Full-scene solve distributed over all processes of the group.

    Each process traces its strided emitter partition (rays split over its
    own ``mesh`` if given), partitions are all-gathered and merged
    identically everywhere. With ``params.reciprocity`` the half-matrix
    work-skip stays on per worker and the transpose back-fill runs after the
    merge, so the result is IDENTICAL to the single-process
    ``view_factor_matrix`` for any process count. Row-sum enforcement (when
    requested) likewise runs on the merged matrix.
    """
    from ..io import merge_vf_matrix
    from ..utils.helpers import enforce_reciprocity_and_rowsum
    from .distribute import backfill_reciprocity, mesh_area

    part, n_parts = _process()
    local = view_factor_matrix_partition(
        meshes, params, n_parts=n_parts, part=part, prepared=prepared,
        mesh=mesh, half_matrix=bool(params.reciprocity),
    )
    merged = merge_vf_matrix(_exchange_rows(local))
    for name, _, _ in meshes:
        merged.setdefault(name, {})

    if params.reciprocity:
        backfill_reciprocity(merged, meshes)
    if params.enforce_reciprocity_rowsum:
        areas = [mesh_area(V, F) for _, V, F in meshes]
        enforce_reciprocity_and_rowsum(merged, meshes, areas)
    return merged


def view_factor_sky_multihost(
    meshes: List[Mesh],
    params,
    *,
    prepared: Optional[PreparedSolver] = None,
    mesh=None,
) -> VFDict:
    """Sky view factors distributed over all processes of the group.

    Sky rows are independent per emitter, so the merged result is IDENTICAL
    to the single-process ``view_factor_to_tregenza_sky`` for any process
    count.
    """
    from ..io import merge_vf_matrix
    from ..solver import _sky_keys

    part, n_parts = _process()
    local = view_factor_sky_partition(
        meshes, params, n_parts=n_parts, part=part, prepared=prepared, mesh=mesh
    )
    merged = merge_vf_matrix(_exchange_rows(local))
    sky_keys = _sky_keys(bool(getattr(params, "discrete", False)))
    for name, _, _ in meshes:
        merged.setdefault(name, {k: 0.0 for k in sky_keys})
    return merged


def view_factor_workflow_multihost(
    meshes: List[Mesh],
    matrix_params,
    sky_params,
    *,
    prepared: Optional[PreparedSolver] = None,
    mesh=None,
) -> Tuple[VFDict, VFDict]:
    """Shared-ray (matrix + sky) solve distributed over all processes.

    Mirrors :func:`view_factor_matrix_multihost`: per-worker partitions with
    the half-matrix skip kept on, transpose back-fill after the merge —
    identical to the single-process ``view_factor_matrix_and_sky`` for any
    process count.
    """
    from ..io import merge_vf_matrix
    from ..solver import _sky_keys
    from .distribute import backfill_reciprocity

    part, n_parts = _process()
    local_vf, local_sky = view_factor_workflow_partition(
        meshes, matrix_params, sky_params, n_parts=n_parts, part=part,
        prepared=prepared, mesh=mesh, half_matrix=bool(matrix_params.reciprocity),
    )
    gathered = _exchange_rows({"vf": local_vf, "sky": local_sky})
    vf_merged = merge_vf_matrix([g["vf"] for g in gathered])
    sky_merged = merge_vf_matrix([g["sky"] for g in gathered])
    sky_keys = _sky_keys(bool(getattr(sky_params, "discrete", False)))
    for name, _, _ in meshes:
        vf_merged.setdefault(name, {})
        sky_merged.setdefault(name, {k: 0.0 for k in sky_keys})
    if matrix_params.reciprocity:
        backfill_reciprocity(vf_merged, meshes)
    return vf_merged, sky_merged


__all__ = [
    "initialize",
    "view_factor_matrix_multihost",
    "view_factor_sky_multihost",
    "view_factor_workflow_multihost",
]
