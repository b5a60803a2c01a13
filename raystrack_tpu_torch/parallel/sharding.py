"""Ray sharding over several devices driven by one process.

Counterpart of ``raystrack_tpu/parallel/sharding.py``. The JAX package
shards a trace over a 1-D device mesh inside ``shard_map``: the per-ray axis
is split over the mesh, the triangle arrays are replicated, and the int32
hit counts are ``psum``-ed, so the result is bitwise the single-device one
for any device count. Here a :class:`RayMesh` is the same single
controller without a compiler: an ordered tuple of devices this process
drives. Each shard runs the port's own chunk or round on its device (the
sweep kernels and the count on a card, their plain versions on the CPU);
every shard is enqueued on its device's current stream before any result
is read, so shards on different cards overlap; the counts then gather on
``mesh.devices[0]``:

- per emitter (:func:`trace_chunk_sharded`): the per-ray tables split into
  contiguous slices, one a shard, and the per-shard counts summed: an exact
  int32 sum of a few hundred bytes, a device-to-device copy and an add;
- a scheduled round (:func:`scheduled_trace_sharded`): the round's schedule
  rows split into contiguous slices and the per-shard rows concatenated in
  row order; each row's counts depend on its own rays only, so no sum is
  needed at all.

A device may appear more than once: a logical mesh of one card (or of the
CPU, which torch exposes as one device) runs its shards one after the
other on that device, as the JAX tests shard over the 8 virtual CPU
devices of ``--xla_force_host_platform_device_count``. Replicated operands
are held once per distinct device (:attr:`RayMesh.distinct`).
"""
from __future__ import annotations

import contextlib
from collections.abc import Mapping
from dataclasses import dataclass
from typing import Dict, Iterable, List, Optional, Tuple

import torch

from ..config import RAY_BLOCK
from ..ops import trace as _trace

RAY_AXIS = "rays"


@dataclass(frozen=True)
class RayMesh:
    """A 1-D mesh of devices along the ray axis: ``devices`` in shard order
    (a device may repeat), results gathering on ``devices[0]``."""

    devices: Tuple[torch.device, ...]

    @property
    def size(self) -> int:
        """Shards a trace splits into."""
        return len(self.devices)

    @property
    def distinct(self) -> Tuple[torch.device, ...]:
        """The mesh's devices without repeats, in first-use order: those that
        hold a copy of the replicated operands."""
        return tuple(dict.fromkeys(self.devices))


def _mesh_device(device) -> torch.device:
    dev = torch.device(device)
    if dev.type == "cpu":
        return torch.device("cpu")
    if dev.type != "cuda":
        raise ValueError(f"a ray mesh holds cuda or cpu devices (got {dev})")
    if not torch.cuda.is_available():
        raise RuntimeError(f"ray mesh device {dev} requested but no CUDA device is available")
    index = torch.cuda.current_device() if dev.index is None else dev.index
    if not 0 <= index < torch.cuda.device_count():
        raise ValueError(f"ray mesh device {dev}: this process sees "
                         f"{torch.cuda.device_count()} CUDA devices")
    return torch.device("cuda", index)


def ray_mesh(devices: Optional[Iterable] = None) -> RayMesh:
    """A 1-D ray mesh over ``devices`` (default: every visible CUDA device).

    ``devices`` are ``torch.device``s or their names; one may appear more
    than once (a logical mesh: ``[torch.device("cuda", 0)] * 4`` splits each
    trace four ways on one card, ``[torch.device("cpu")] * 8`` eight ways on
    the CPU). With no card and no ``devices`` it raises: there is no silent
    CPU mesh. A mesh that mixes device types raises ``ValueError``.
    """
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "ray_mesh() spans every visible CUDA device and none is available; "
                "pass devices= (e.g. [torch.device('cpu')] * 8) for a mesh of CPU shards")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    devs = tuple(_mesh_device(d) for d in devices)
    if not devs:
        raise ValueError("a ray mesh needs at least one device")
    kinds = sorted({d.type for d in devs})
    if len(kinds) > 1:
        raise ValueError(f"a ray mesh cannot mix device types (got {', '.join(kinds)})")
    return RayMesh(devs)


def _device_scope(device: torch.device):
    """The CUDA device context a shard is enqueued under (none on the CPU)."""
    return torch.cuda.device(device) if device.type == "cuda" else contextlib.nullcontext()


class _Local:
    """Per call: an argument's value on one shard's device. A mapping is
    taken as the caller's replicas ``{device: value}``; a tensor on another
    device is copied there once a device, without waiting on queued work;
    tuples recurse; anything else (None, host floats) passes."""

    def __init__(self):
        # (id, device) -> (the tensor, its copy): holding the tensor keeps
        # its id from being reused by another while the call lasts
        self._copies: Dict[Tuple[int, torch.device], Tuple[torch.Tensor, torch.Tensor]] = {}

    def __call__(self, x, device: torch.device):
        if isinstance(x, Mapping):
            if device not in x:
                raise ValueError(f"no replica on {device} (replicas on {list(x)})")
            return x[device]
        if isinstance(x, tuple):
            return tuple(self(t, device) for t in x)
        if not isinstance(x, torch.Tensor) or x.device == device:
            return x
        key = (id(x), device)
        if key not in self._copies:
            self._copies[key] = (x, x.to(device, non_blocking=True))
        return self._copies[key][1]


def trace_chunk_sharded(
    mesh: RayMesh,
    tri_pack,
    sweep_mask,
    tables,
    geom,
    cp,
    n_surf: int,
    n_rays_once: int,
    accel=None,
    code_bounds=None,
    *,
    want_matrix: bool = True,
    want_any: bool = False,
    discrete: bool = False,
) -> Dict[str, torch.Tensor]:
    """:func:`ops.trace.chunk_body` split over ``mesh`` along the ray axis:
    the same counts, bitwise, for any shard count.

    The per-ray ``tables`` must be padded to a multiple of ``RAY_BLOCK *
    mesh.size`` (the solver's ``_ray_align``). Shard s traces the s-th
    contiguous slice with ``ray_index_base = s * n_local``; its counts are
    summed onto ``mesh.devices[0]``. Every other argument is replicated: a
    tensor is copied to each device it is not on, or the caller passes its
    replicas as ``{device: value}`` for every distinct device of the mesh
    (``tables`` as ``{device: tuple}``).
    """
    local = _Local()

    def full_tables(dev):  # sliced before any copy: a shard moves only its rays
        return local(tables, dev) if isinstance(tables, Mapping) else tables

    n_pad = full_tables(mesh.devices[0])[0].shape[0]
    if n_pad % (RAY_BLOCK * mesh.size):
        raise ValueError(
            f"per-ray tables ({n_pad} rays) must be padded to a multiple of "
            f"RAY_BLOCK * mesh.size = {RAY_BLOCK * mesh.size}")
    n_local = n_pad // mesh.size
    outs: List[Dict[str, torch.Tensor]] = []
    for shard, dev in enumerate(mesh.devices):
        rows = slice(shard * n_local, (shard + 1) * n_local)
        with _device_scope(dev):
            outs.append(_trace.chunk_body(
                local(tri_pack, dev), local(sweep_mask, dev),
                tuple(t[rows].to(dev, non_blocking=True) for t in full_tables(dev)),
                local(geom, dev), local(cp, dev), n_surf, n_rays_once,
                accel=local(accel, dev), code_bounds=code_bounds,
                ray_index_base=shard * n_local, want_matrix=want_matrix,
                want_any=want_any, discrete=discrete,
            ))
    total: Dict[str, torch.Tensor] = {}
    home = mesh.devices[0]
    for out in outs:
        for key, counts in out.items():
            counts = counts.to(home, non_blocking=True)
            total[key] = counts if key not in total else total[key] + counts
    return total


def scheduled_trace_sharded(
    mesh: RayMesh,
    scene,
    tri_pack,
    tables_flat,
    geom_stacked,
    cp,
    surf_active_ext,
    emit_sid,
    min_sid,
    n_rays_once,
    plane_vec,
    schedule: torch.Tensor,
    sel,
    *,
    sched_block: int,
    tri_tile: Optional[int] = None,
    accel=None,
    want_matrix: bool = True,
    want_any: bool = False,
    discrete: bool = False,
) -> torch.Tensor:
    """:func:`ops.trace.scheduled_trace` with the schedule rows split over
    ``mesh``: the same packed counts, bitwise, for any shard count.

    Scheduled rounds are embarrassingly parallel across schedule rows (each
    row's histogram depends only on its own rays), so the (nb, 4) schedule
    splits into ``mesh.size`` near-equal contiguous slices
    (``torch.tensor_split``; a shard left with no row launches nothing),
    everything else is replicated as in :func:`trace_chunk_sharded`, and
    the per-shard rows, concatenated in row order on ``mesh.devices[0]``,
    are the single-device result. Unlike the JAX package, whose compiled
    step needs equal shards, the rows are not padded up to a multiple of
    the device count.
    """
    local = _Local()
    outs: List[Dict[str, torch.Tensor]] = []
    for dev, rows in zip(mesh.devices, torch.tensor_split(schedule, mesh.size)):
        if rows.shape[0] == 0:
            continue
        with _device_scope(dev):
            outs.append(_trace.scheduled_trace(
                *(local(x, dev) for x in (
                    scene, tri_pack, tables_flat, geom_stacked, cp, surf_active_ext,
                    emit_sid, min_sid, n_rays_once, plane_vec, rows, sel)),
                sched_block=sched_block, tri_tile=tri_tile, accel=local(accel, dev),
                want_matrix=want_matrix, want_any=want_any, discrete=discrete,
                pack_out=False,
            ))
    home = mesh.devices[0]
    return _trace.pack_outputs({
        key: torch.cat([out[key].to(home, non_blocking=True) for out in outs])
        for key in outs[0]
    })


__all__ = ["RAY_AXIS", "RayMesh", "ray_mesh", "scheduled_trace_sharded", "trace_chunk_sharded"]
