# Host side copied from raystrack_tpu/prepared.py (host-only NumPy); the device packs are torch.
"""Scene/emitter preparation and cached device packing (PyTorch port).

The host side is copied from ``raystrack_tpu/prepared.py`` (host-only
NumPy), so prepared arrays are bitwise equal to the JAX package's:

- triangle soup ``(v0, e1, e2, sid)`` per scene with safe-normalized normals,
- per-emitter emission tables: orthonormal triangle frames, area CDF,
  stratified Halton grid sized by ``grid_from_density``, five per-ray Halton
  dimensions, self-hit origin epsilon, and emitter-plane coplanarity data
  used for receiver culling.

The device side packs those tables into padded tensors on an explicit
``torch.device``:

- triangles are zero-padded to a multiple of 128 (of ``PALLAS_TRI_TILE``
  past ``PALLAS_MAX_TRIS``, as the JAX package pads); a padded triangle has
  ``e1 = e2 = 0`` so its intersection determinant is exactly 0 and it can
  never register a hit,
- with acceleration on, each run of ``ACCEL_GRAIN`` Morton-ordered
  triangles gets an AABB, from which the sweeps' distance gate builds its
  boxes,
- padded triangle surface-ids point at a sentinel slot appended to the
  surface-active vector,
- per-cell jitter values are pre-expanded to per-ray tables,
- per-triangle intersection operands are precomputed so the Möller–Trumbore
  test reduces to dot products against the ray and its origin-direction
  cross product (see ops/trace_cuda.py),
- at or above ``SLIM_PACK_MIN_TRIS`` padded triangles the scene pack is
  slim (pack-resident): the sweep's (24, Tpad) operand pack is built once,
  in chunks through a pinned staging buffer, and only it, the surface ids
  and the boxes live on the device.

``PreparedSolver`` caches all of it across solves: the scene by accel flag,
emitters by (samples, rays, flip_faces), device packs and the scheduled
driver's flat tables additionally by device and padding alignment.
"""
from __future__ import annotations

import functools as _functools
import warnings
from dataclasses import dataclass
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from . import config as _cfg
from .config import ACCEL_GRAIN, RAY_BLOCK
from .ops.halton import Table, cached_halton, cached_halton_dims
from .ops.trace_cuda import TRI_ROWS
from .utils.helpers import grid_from_density

Mesh = Tuple[str, np.ndarray, np.ndarray]


# ---------------------------------------------------------------------------
# Host-side prepared state (copied from raystrack_tpu/prepared.py)
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class PreparedScene:
    """Flattened triangle soup for the whole scene (host arrays)."""

    v0: np.ndarray  # (T, 3) f32
    e1: np.ndarray  # (T, 3) f32
    e2: np.ndarray  # (T, 3) f32
    normals: np.ndarray  # (T, 3) f32, unit
    sid: np.ndarray  # (T,) i32 surface (mesh) index
    use_accel: bool  # whether Morton ordering was requested


@dataclass(frozen=True)
class PreparedEmitter:
    """Per-mesh emission geometry plus LAZY QMC tables (host arrays).

    The Halton jitter grid and the five per-ray dimensions are built on
    first access: a scene's emitter list covers every mesh, but solves
    typically trace only a few of them.
    """

    tri_a: np.ndarray  # (F, 3) f32
    tri_e1: np.ndarray  # (F, 3) f32
    tri_e2: np.ndarray  # (F, 3) f32
    tri_u: np.ndarray  # (F, 3) f32 tangent frame
    tri_v: np.ndarray  # (F, 3) f32
    tri_n: np.ndarray  # (F, 3) f32 unit normal
    tri_origin_eps: np.ndarray  # (F,) f32 self-hit offset along normal
    plane_origin: np.ndarray  # (3,) f32
    plane_normal: np.ndarray  # (3,) f32
    plane_tol: float
    plane_is_planar: bool
    cdf: np.ndarray  # (F,) f32 area CDF
    total_area: float
    g: int  # stratified grid side
    rays: int  # rays per cell the tables are sized for
    zero_area: bool = False  # degenerate emitters get all-zero tables

    @property
    def n_cells(self) -> int:
        return int(self.g * self.g)

    # functools.cached_property writes straight into __dict__, which works
    # on a frozen dataclass (no __slots__)
    @_functools.cached_property
    def _grids(self) -> Tuple[np.ndarray, np.ndarray]:
        if self.zero_area:
            zero = np.zeros(self.n_cells, dtype=np.float32)
            return zero, zero.copy()
        return cached_halton(self.g)

    @property
    def u_grid(self) -> np.ndarray:  # (g*g,) f32 per-cell jitter
        return self._grids[0]

    @property
    def v_grid(self) -> np.ndarray:  # (g*g,) f32
        return self._grids[1]

    @_functools.cached_property
    def _dims(self) -> Tuple[np.ndarray, ...]:
        n = self.n_cells * self.rays
        if self.zero_area:
            zero = np.zeros(n, dtype=np.float32)
            return (zero,) * 5
        return cached_halton_dims(n)

    @property
    def halton_tri(self) -> np.ndarray:  # (g*g*rays,) f32
        return self._dims[0]

    @property
    def halton_u(self) -> np.ndarray:
        return self._dims[1]

    @property
    def halton_v(self) -> np.ndarray:
        return self._dims[2]

    @property
    def halton_r1(self) -> np.ndarray:
        return self._dims[3]

    @property
    def halton_r2(self) -> np.ndarray:
        return self._dims[4]

    def dims_on(self, device) -> Tuple[Table, ...]:
        """The five per-ray dimensions for a pack on ``device``: tensors built
        on a CUDA device where the device builder takes their length (see
        ``ops.halton._halton_dim``), else the host arrays of ``halton_*``.
        Not kept on the emitter: the dims cache bounds what device tables
        stay alive."""
        if self.zero_area:
            return self._dims
        return cached_halton_dims(self.n_cells * self.rays, device)

    def grids_on(self, device) -> Tuple[Table, Table]:
        """``(u_grid, v_grid)`` for a pack on ``device``, as ``dims_on``
        gives the dimensions (the grid's ``g*g`` cells decide)."""
        if self.zero_area:
            return self._grids
        return cached_halton(self.g, device)


def _safe_unit(v: np.ndarray) -> np.ndarray:
    norm = np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-12)
    return v / norm


def _triangle_frames(tri_n: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Orthonormal tangent frame (u, v) per unit normal, vectorized.

    Picks the world X axis unless ``|n_x| >= 0.9`` (then Y), falls back to
    the other axis on degeneracy, and finally to the identity frame.
    """
    n = tri_n.astype(np.float32)
    count = n.shape[0]
    ex = np.broadcast_to(np.array([1.0, 0.0, 0.0], np.float32), (count, 3))
    ey = np.broadcast_to(np.array([0.0, 1.0, 0.0], np.float32), (count, 3))

    use_x = (np.abs(n[:, 0]) < 0.9)[:, None]
    ref1 = np.where(use_x, ex, ey)
    u1 = np.cross(ref1, n).astype(np.float32)
    len1 = np.linalg.norm(u1, axis=1, keepdims=True)

    ref2 = np.where(use_x, ey, ex)
    u2 = np.cross(ref2, n).astype(np.float32)
    len2 = np.linalg.norm(u2, axis=1, keepdims=True)

    first_ok = len1 > 1e-12
    second_ok = len2 > 1e-12
    u = np.where(first_ok, u1 / np.maximum(len1, 1e-30), 0.0)
    u = np.where(~first_ok & second_ok, u2 / np.maximum(len2, 1e-30), u)
    v = np.cross(n, u).astype(np.float32)
    degenerate = (~first_ok & ~second_ok).ravel()
    if np.any(degenerate):
        u[degenerate] = ex[degenerate]
        v[degenerate] = ey[degenerate]
    return u.astype(np.float32), v.astype(np.float32)


def _triangle_origin_eps(tri_e1: np.ndarray, tri_e2: np.ndarray) -> np.ndarray:
    """Per-triangle ray-origin offset: 1e-6 of the longest edge, min 1e-8."""
    edges = np.stack(
        [
            np.linalg.norm(tri_e1, axis=1),
            np.linalg.norm(tri_e2, axis=1),
            np.linalg.norm(tri_e2 - tri_e1, axis=1),
        ],
        axis=0,
    )
    return np.maximum(edges.max(axis=0) * 1.0e-6, 1.0e-8).astype(np.float32)


def _emitter_plane(
    tri_a: np.ndarray,
    tri_e1: np.ndarray,
    tri_e2: np.ndarray,
    tri_n: np.ndarray,
    tri_origin_eps: np.ndarray,
) -> Tuple[np.ndarray, np.ndarray, float, bool]:
    """Detect whether the emitter is a single coplanar, co-oriented surface.

    Returns (origin, normal, tolerance, is_planar); planar emitters enable
    culling of receivers that lie entirely behind the emission plane.
    """
    plane_tol = float(max(1.0e-7, float(tri_origin_eps.max()) if tri_origin_eps.size else 0.0))
    zero3 = np.zeros(3, dtype=np.float32)
    if tri_a.shape[0] == 0:
        return zero3, zero3, plane_tol, False

    origin = np.asarray(tri_a[0], dtype=np.float32)
    normal = np.asarray(tri_n[0], dtype=np.float32)
    n_len = float(np.linalg.norm(normal))
    if n_len <= 1.0e-12:
        return origin, normal, plane_tol, False
    normal = (normal / n_len).astype(np.float32)

    if np.any(tri_n @ normal < (1.0 - 1.0e-4)):
        return origin, normal, plane_tol, False

    corners = (tri_a, tri_a + tri_e1, tri_a + tri_e2)
    max_dev = max(
        float(np.max(np.abs((pts - origin) @ normal))) if pts.size else 0.0
        for pts in corners
    )
    if max_dev > plane_tol:
        return origin, normal, plane_tol, False
    return origin, normal, plane_tol, True


def prepare_scene(meshes: List[Mesh], *, use_accel: bool = False) -> PreparedScene:
    """Flatten all meshes into a triangle soup with surface ids."""
    if not meshes or sum(F.shape[0] for _, _, F in meshes) == 0:
        empty3 = np.empty((0, 3), dtype=np.float32)
        return PreparedScene(
            empty3, empty3.copy(), empty3.copy(), empty3.copy(),
            np.empty((0,), dtype=np.int32), False,
        )

    v0s, e1s, e2s, ns, sids = [], [], [], [], []
    for sid, (_, V, F) in enumerate(meshes):
        a = np.asarray(V[F[:, 0]], dtype=np.float32)
        b = np.asarray(V[F[:, 1]], dtype=np.float32)
        c = np.asarray(V[F[:, 2]], dtype=np.float32)
        e1 = b - a
        e2 = c - a
        v0s.append(a)
        e1s.append(e1)
        e2s.append(e2)
        ns.append(_safe_unit(np.cross(e1, e2)).astype(np.float32))
        sids.append(np.full(F.shape[0], sid, dtype=np.int32))

    return PreparedScene(
        v0=np.concatenate(v0s),
        e1=np.concatenate(e1s),
        e2=np.concatenate(e2s),
        normals=np.concatenate(ns),
        sid=np.concatenate(sids),
        use_accel=bool(use_accel),
    )


def prepare_emitters(
    meshes: List[Mesh], *, samples: int, rays: int, flip_faces: bool
) -> List[PreparedEmitter]:
    """Build per-mesh emission tables."""
    emitters: List[PreparedEmitter] = []
    for _, V, F in meshes:
        F_emit = F[:, [0, 2, 1]] if flip_faces else F
        tri_a = np.asarray(V[F_emit[:, 0]], dtype=np.float32)
        tri_b = np.asarray(V[F_emit[:, 1]], dtype=np.float32)
        tri_c = np.asarray(V[F_emit[:, 2]], dtype=np.float32)
        tri_e1 = tri_b - tri_a
        tri_e2 = tri_c - tri_a

        raw_n = np.cross(tri_e1, tri_e2).astype(np.float32)
        twice_area = np.linalg.norm(raw_n, axis=1)
        tri_n = _safe_unit(raw_n).astype(np.float32)
        tri_u, tri_v = _triangle_frames(tri_n)
        eps = _triangle_origin_eps(tri_e1, tri_e2)
        plane_origin, plane_normal, plane_tol, plane_is_planar = _emitter_plane(
            tri_a, tri_e1, tri_e2, tri_n, eps
        )

        areas = 0.5 * twice_area
        total_area = float(areas.sum())
        zero_area = total_area <= 0.0
        if zero_area:
            cdf = np.ones(F_emit.shape[0], dtype=np.float32)
            g = 4
        else:
            cdf64 = np.cumsum(areas, dtype=np.float64)
            cdf = (cdf64 / cdf64[-1]).astype(np.float32)
            g = grid_from_density(total_area, samples)

        emitters.append(
            PreparedEmitter(
                tri_a=tri_a,
                tri_e1=tri_e1,
                tri_e2=tri_e2,
                tri_u=tri_u,
                tri_v=tri_v,
                tri_n=tri_n,
                tri_origin_eps=eps,
                plane_origin=plane_origin,
                plane_normal=plane_normal,
                plane_tol=plane_tol,
                plane_is_planar=plane_is_planar,
                cdf=cdf,
                total_area=total_area,
                g=g,
                rays=int(rays),
                zero_area=zero_area,
            )
        )
    return emitters


def _round_up(n: int, align: int) -> int:
    return ((max(n, 1) + align - 1) // align) * align


def _pad_rays(n: int, align: int) -> int:
    """Padded per-emitter ray count: align to blocks, then (by default)
    bucket the block count into the {2^i, 3*2^i} series. Padded tail rays
    are masked out of every count."""
    from .config import RAY_BUCKETING

    blocks = (max(n, 1) + align - 1) // align
    if not RAY_BUCKETING:
        return blocks * align
    size = 1
    while size < blocks:
        if size * 3 // 2 >= blocks and size % 2 == 0:
            size = size * 3 // 2
            break
        size *= 2
    return size * align


def morton_order(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray) -> np.ndarray:
    """Triangle permutation by 30-bit Morton code of quantized centroids.

    Spatially clustering triangles makes per-emitter culling coherent at the
    tile level: unreachable triangles land in contiguous tiles that the
    sweep skips whole. The order also decides how exact distance ties
    resolve, so it must match the JAX package's.
    """
    centroid = v0 + (e1 + e2) / 3.0
    lo = centroid.min(axis=0)
    span = np.maximum(centroid.max(axis=0) - lo, 1e-12)
    q = np.clip(((centroid - lo) / span) * 1023.0, 0, 1023).astype(np.uint64)

    def spread(x: np.ndarray) -> np.ndarray:
        x = (x | (x << 16)) & np.uint64(0x030000FF)
        x = (x | (x << 8)) & np.uint64(0x0300F00F)
        x = (x | (x << 4)) & np.uint64(0x030C30C3)
        x = (x | (x << 2)) & np.uint64(0x09249249)
        return x

    code = spread(q[:, 0]) | (spread(q[:, 1]) << np.uint64(1)) | (
        spread(q[:, 2]) << np.uint64(2)
    )
    return np.argsort(code, kind="stable").astype(np.int32)


def emitter_plane_vec(emitter: PreparedEmitter) -> np.ndarray:
    """The (8,) f32 ``[plane_origin, plane_normal, plane_tol, is_planar]``
    culling vector."""
    return np.concatenate(
        [
            emitter.plane_origin.astype(np.float32),
            emitter.plane_normal.astype(np.float32),
            np.float32([emitter.plane_tol, 1.0 if emitter.plane_is_planar else 0.0]),
        ]
    )


# ---------------------------------------------------------------------------
# Device packing
# ---------------------------------------------------------------------------


@dataclass(frozen=True)
class ScenePack:
    """Padded scene tensors on one device, plus derived trace operands.

    The derived per-triangle vectors let the Möller–Trumbore test run as dot
    products against ray quantities only (o, d, o×d):

    - ``det   = -(d · cross_e)``          with ``cross_e = e1 × e2``
    - ``u_num =  (o×d) · e2 + d · (v0 × e2)``
    - ``v_num = -(o×d) · e1 - d · (v0 × e1)``
    - ``t_num =  o · cross_e - v0 · cross_e``

    and the front/back flag is ``det > 0``. Field for field the JAX
    package's ScenePack. A slim (pack-resident) pack holds ``tri_pack``, the
    sweep's operand pack built once from the same values, and None in the
    seven per-triangle fields; ``sid`` and the boxes stay.
    """

    v0: Optional[torch.Tensor]  # (Tp, 3) f32
    e1: Optional[torch.Tensor]  # (Tp, 3) f32
    e2: Optional[torch.Tensor]  # (Tp, 3) f32
    cross_e: Optional[torch.Tensor]  # (Tp, 3) f32  e1 x e2
    w_u: Optional[torch.Tensor]  # (Tp, 3) f32  v0 x e2
    w_v: Optional[torch.Tensor]  # (Tp, 3) f32  v0 x e1
    d0: Optional[torch.Tensor]  # (Tp,) f32   v0 . cross_e
    sid: torch.Tensor  # (Tp,) i32   padded entries = n_surf (sentinel)
    n_tri: int
    n_tri_pad: int
    tri_tile: int
    n_surf: int
    # AABB per ACCEL_GRAIN triangles, only with acceleration on; a fully
    # padded grain gets the empty box (lo > hi) that every slab test misses
    tile_lo: Optional[torch.Tensor] = None  # (Tp / ACCEL_GRAIN, 3) f32
    tile_hi: Optional[torch.Tensor] = None  # (Tp / ACCEL_GRAIN, 3) f32
    # slim mode only: rows 0-16 of ops/trace_cuda.py's pack layout (operands
    # and 2*sid), mask rows and padding rows zero; every emitter sweeps it as
    # it is, with eligibility from the code row (sweep_rays' code_bounds)
    tri_pack: Optional[torch.Tensor] = None  # (TRI_ROWS, Tp) f32

    @property
    def accel(self) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
        """``(tile_lo, tile_hi)``, the sweeps' ``accel`` argument, or None."""
        if self.tile_lo is None:
            return None
        return (self.tile_lo, self.tile_hi)

    @property
    def slim(self) -> bool:
        return self.tri_pack is not None


@dataclass(frozen=True)
class EmitterPack:
    """Padded per-ray emission tables on one device.

    Per-cell jitter is pre-expanded to per-ray (``rays`` consecutive rays
    share a cell), so ray generation is elementwise plus one CDF search and
    one triangle gather.
    """

    u_cell: torch.Tensor  # (Np,) f32
    v_cell: torch.Tensor  # (Np,) f32
    h_tri: torch.Tensor  # (Np,) f32
    h_u: torch.Tensor
    h_v: torch.Tensor
    h_r1: torch.Tensor
    h_r2: torch.Tensor
    cdf: torch.Tensor  # (F,) f32
    tri_a: torch.Tensor  # (F, 3) f32
    tri_e1: torch.Tensor
    tri_e2: torch.Tensor
    tri_u: torch.Tensor
    tri_v: torch.Tensor
    tri_n: torch.Tensor
    tri_eps: torch.Tensor  # (F,) f32
    plane_vec: torch.Tensor  # (8,) f32 [origin, normal, tol, is_planar]
    n_rays_once: int  # true rays per iteration (pre-padding)
    n_rays_pad: int


def _put(a: np.ndarray, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(a)).to(device)


def pick_tri_tile(n_tri_pad: int) -> int:
    """Largest tile width from {TRI_TILE, ..., 128} dividing the padded count."""
    tile = _cfg.TRI_TILE
    while tile > 128 and n_tri_pad % tile != 0:
        tile //= 2
    return max(128, min(tile, n_tri_pad))


# Empty-box sentinel: any slab test against (lo=+BIG, hi=-BIG) misses.
_ACCEL_EMPTY = 3.0e37


def _tile_bounds(
    v0: np.ndarray, e1: np.ndarray, e2: np.ndarray, n_tri: int
) -> Tuple[np.ndarray, np.ndarray]:
    """(n_tiles, 3) AABB lo/hi per ACCEL_GRAIN-triangle tile (padded arrays).

    Only real triangles contribute; fully padded tiles get the empty box.
    """
    n_tri_pad = v0.shape[0]
    pts = np.stack([v0, v0 + e1, v0 + e2], axis=1).astype(np.float32)  # (Tp,3,3)
    real = np.arange(n_tri_pad) < n_tri
    pts = np.where(real[:, None, None], pts, np.float32(np.nan))
    tiles = pts.reshape(n_tri_pad // ACCEL_GRAIN, ACCEL_GRAIN * 3, 3)
    with warnings.catch_warnings(), np.errstate(invalid="ignore"):
        # fully padded tiles are all-NaN on purpose; they become empty boxes
        warnings.simplefilter("ignore", RuntimeWarning)
        lo = np.nanmin(tiles, axis=1)
        hi = np.nanmax(tiles, axis=1)
    lo = np.where(np.isnan(lo), np.float32(_ACCEL_EMPTY), lo).astype(np.float32)
    hi = np.where(np.isnan(hi), np.float32(-_ACCEL_EMPTY), hi).astype(np.float32)
    return lo, hi


# Triangles per fill step of the slim pack build: one pinned (17, chunk)
# staging buffer on the host and one slab of the same size in flight on the
# device.
_PACK_BUILD_CHUNK = 4_194_304

# Pack rows the slim build fills: the operands and the code row.
_PACK_BUILD_ROWS = 17


def _build_pack_resident(v0: np.ndarray, e1: np.ndarray, e2: np.ndarray, sid: np.ndarray,
                         device: torch.device) -> torch.Tensor:
    """The device-resident (TRI_ROWS, Tpad) sweep operand pack of a slim
    scene, from the padded host arrays.

    Rows 0-16 are computed on the host, ``_PACK_BUILD_CHUNK`` triangles at a
    time, with the NumPy formulas full mode uses, written into a pinned
    staging buffer and copied into a column slice of the one preallocated
    pack; the mask rows and padding rows stay zero. So the pack is bitwise
    equal to ``build_tri_pack`` of the full-mode fields with zero masks,
    and the device never holds more than the pack and one chunk's slab.
    """
    n = int(v0.shape[0])
    on_card = device.type == "cuda"
    pack = torch.zeros((TRI_ROWS, n), dtype=torch.float32, device=device)
    chunk = min(n, _PACK_BUILD_CHUNK)
    stage = torch.empty(_PACK_BUILD_ROWS * chunk, dtype=torch.float32, pin_memory=on_card)
    for off in range(0, n, chunk):
        c = min(chunk, n - off)
        sl = slice(off, off + c)
        rows_t = stage[: _PACK_BUILD_ROWS * c].view(_PACK_BUILD_ROWS, c)
        rows = rows_t.numpy()
        ce = np.cross(e1[sl], e2[sl]).astype(np.float32)
        rows[0:3] = ce.T
        rows[3:6] = e1[sl].T
        rows[6:9] = e2[sl].T
        rows[9:12] = np.cross(v0[sl], e2[sl]).astype(np.float32).T
        rows[12:15] = np.cross(v0[sl], e1[sl]).astype(np.float32).T
        rows[15] = np.einsum("ij,ij->i", v0[sl], ce).astype(np.float32)
        rows[16] = (sid[sl] * 2).astype(np.float32)
        pack[:_PACK_BUILD_ROWS, sl].copy_(rows_t, non_blocking=on_card)
        if on_card:  # the next chunk overwrites the staging buffer
            torch.cuda.current_stream(device).synchronize()
    return pack


def pack_scene(scene: PreparedScene, n_surf: int, *, device: torch.device,
               slim: Optional[bool] = None) -> ScenePack:
    """Pad the triangle soup (Morton-ordered when the scene was prepared
    with ``use_accel``, then with its acceleration boxes) and upload it to
    ``device``.

    The padded count is a multiple of 128, and of ``PALLAS_TRI_TILE`` once
    it passes ``PALLAS_MAX_TRIS``, so a large scene's sweep tile stays
    ``PALLAS_TRI_TILE`` wide. Padding, derived operands and boxes are
    computed on the host with the JAX package's NumPy formulas, so the
    packs are bitwise equal to its ``pack_scene``.

    ``slim`` (default: at or above ``SLIM_PACK_MIN_TRIS`` padded triangles)
    builds the pack-resident form instead: ``tri_pack``, ``sid`` and the
    boxes on the device, the per-triangle fields None.
    """
    n_tri = int(scene.v0.shape[0])
    n_tri_pad = _round_up(n_tri, 128)
    if n_tri_pad > _cfg.PALLAS_MAX_TRIS:
        n_tri_pad = _round_up(n_tri, _cfg.PALLAS_TRI_TILE)
    if slim is None:
        slim = n_tri_pad >= _cfg.SLIM_PACK_MIN_TRIS

    if scene.use_accel and n_tri > 1:
        perm = morton_order(scene.v0, scene.e1, scene.e2)
    else:
        perm = np.arange(n_tri, dtype=np.int32)

    def pad3(a: np.ndarray) -> np.ndarray:
        out = np.zeros((n_tri_pad, 3), dtype=np.float32)
        out[:n_tri] = a[perm]
        return out

    v0 = pad3(scene.v0)
    e1 = pad3(scene.e1)
    e2 = pad3(scene.e2)
    sid = np.full(n_tri_pad, n_surf, dtype=np.int32)
    sid[:n_tri] = scene.sid[perm]

    if scene.use_accel and n_tri > 0:
        tile_lo, tile_hi = (_put(a, device) for a in _tile_bounds(v0, e1, e2, n_tri))
    else:
        tile_lo = tile_hi = None
    tri_tile = pick_tri_tile(n_tri_pad)
    if slim:
        return ScenePack(
            v0=None, e1=None, e2=None, cross_e=None, w_u=None, w_v=None, d0=None,
            sid=_put(sid, device), n_tri=n_tri, n_tri_pad=n_tri_pad, tri_tile=tri_tile,
            n_surf=n_surf, tile_lo=tile_lo, tile_hi=tile_hi,
            tri_pack=_build_pack_resident(v0, e1, e2, sid, device),
        )

    cross_e = np.cross(e1, e2).astype(np.float32)
    w_u = np.cross(v0, e2).astype(np.float32)
    w_v = np.cross(v0, e1).astype(np.float32)
    d0 = np.einsum("ij,ij->i", v0, cross_e).astype(np.float32)
    return ScenePack(
        v0=_put(v0, device),
        e1=_put(e1, device),
        e2=_put(e2, device),
        cross_e=_put(cross_e, device),
        w_u=_put(w_u, device),
        w_v=_put(w_v, device),
        d0=_put(d0, device),
        sid=_put(sid, device),
        n_tri=n_tri,
        n_tri_pad=n_tri_pad,
        tri_tile=tri_tile,
        n_surf=n_surf,
        tile_lo=tile_lo,
        tile_hi=tile_hi,
    )


def _on(a: Table, device: torch.device) -> torch.Tensor:
    """``a`` on ``device``: a device-built table as it is, a host array
    uploaded unpadded."""
    return a if isinstance(a, torch.Tensor) else _put(a, device)


def pack_emitter(
    emitter: PreparedEmitter,
    rays: int,
    *,
    align: int = RAY_BLOCK,
    device: torch.device,
) -> EmitterPack:
    """Pad the per-ray tables to ``_pad_rays(n_cells * rays, align)`` and
    upload them with the emission geometry to ``device``.

    Every table is padded on ``device``, and the per-ray cell jitter is
    repeated there from the (g*g,) grids. Tables built on ``device`` (a big
    emitter on a card: ``PreparedEmitter.dims_on``, ``grids_on``) stay
    there; host ones are uploaded unpadded. Either way the pack is bitwise
    the same."""
    n_rays_once = emitter.n_cells * rays
    n_rays_pad = _pad_rays(n_rays_once, align)
    put = lambda a: _put(a, device)  # noqa: E731

    def ray_table(a: torch.Tensor) -> torch.Tensor:
        return torch.nn.functional.pad(a, (0, n_rays_pad - a.shape[0]))

    u_cell, v_cell = (ray_table(torch.repeat_interleave(_on(grid, device), rays))
                      for grid in emitter.grids_on(device))
    h_tri, h_u, h_v, h_r1, h_r2 = (ray_table(_on(d, device)) for d in emitter.dims_on(device))
    return EmitterPack(
        u_cell=u_cell,
        v_cell=v_cell,
        h_tri=h_tri,
        h_u=h_u,
        h_v=h_v,
        h_r1=h_r1,
        h_r2=h_r2,
        cdf=put(emitter.cdf),
        tri_a=put(emitter.tri_a),
        tri_e1=put(emitter.tri_e1),
        tri_e2=put(emitter.tri_e2),
        tri_u=put(emitter.tri_u),
        tri_v=put(emitter.tri_v),
        tri_n=put(emitter.tri_n),
        tri_eps=put(emitter.tri_origin_eps),
        plane_vec=put(emitter_plane_vec(emitter)),
        n_rays_once=n_rays_once,
        n_rays_pad=n_rays_pad,
    )


class LazyEmitterPack:
    """Deferred EmitterPack: the ray counts and the host plane vector are
    there at once; the per-ray device tables are built (``pack_emitter``:
    on the device where its Halton tables are) only if a per-emitter
    dispatch touches them.

    The scheduled driver reads rays from the scene-wide flat tables, so
    with this wrapper a scheduled solve never holds a second device copy of
    every emitter's padded ray tables.
    """

    def __init__(self, factory, *, n_rays_once: int, n_rays_pad: int,
                 plane_host: np.ndarray):
        self._factory = factory
        self._pack: Optional[EmitterPack] = None
        self.n_rays_once = n_rays_once
        self.n_rays_pad = n_rays_pad
        self.plane_host = plane_host

    def __getattr__(self, name):
        if name.startswith("__"):  # no pack for copy/pickle protocol probes
            raise AttributeError(name)
        if self._pack is None:
            self._pack = self._factory()
        return getattr(self._pack, name)


# ---------------------------------------------------------------------------
# PreparedSolver cache
# ---------------------------------------------------------------------------


def _device_key(device) -> str:
    """One cache key per physical device: an index-less CUDA device means
    the current card, so ``"cuda"`` and ``"cuda:0"`` share their packs, and
    ``None`` means the device a solve with ``device="auto"`` takes (the
    current card, else the CPU), keyed as that device named outright."""
    if device is None:
        from .solver import _resolve_device

        device = _resolve_device("auto")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return str(dev)


class PreparedSolver:
    """Cache prepared geometry, ray tables and device packs across solves.

    Reusing one instance across repeated solves on the same mesh set skips
    rebuilding triangle buffers, Halton tables and device uploads (changing
    only the seed reuses everything).
    """

    def __init__(self, meshes: List[Mesh]):
        self.meshes = list(meshes)
        self.total_faces = int(sum(F.shape[0] for _, _, F in self.meshes))
        self._scene_cache: Dict[bool, PreparedScene] = {}
        self._emitter_cache: Dict[Tuple[int, int, bool], List[PreparedEmitter]] = {}
        self._scene_pack_cache: Dict[Tuple[str, bool], ScenePack] = {}
        self._emitter_pack_cache: Dict[Tuple, EmitterPack] = {}
        self._flat_cache: Dict[Tuple, Tuple] = {}
        self._mesh_bounds_cache = None

    # -- host state --------------------------------------------------------

    def get_scene(self, *, use_accel: bool = False) -> PreparedScene:
        key = bool(use_accel)
        if key not in self._scene_cache:
            self._scene_cache[key] = prepare_scene(self.meshes, use_accel=key)
        return self._scene_cache[key]

    def get_emitters(
        self, *, samples: int, rays: int, flip_faces: bool
    ) -> List[PreparedEmitter]:
        key = (int(samples), int(rays), bool(flip_faces))
        if key not in self._emitter_cache:
            self._emitter_cache[key] = prepare_emitters(
                self.meshes, samples=samples, rays=rays, flip_faces=flip_faces
            )
        return self._emitter_cache[key]

    def get_emitter(
        self, index: int, *, samples: int, rays: int, flip_faces: bool
    ) -> PreparedEmitter:
        return self.get_emitters(samples=samples, rays=rays, flip_faces=flip_faces)[
            int(index)
        ]

    def get_mesh_bounds(self) -> Tuple[np.ndarray, np.ndarray]:
        """Per-mesh AABB (centers, half-extents) for emitter-plane culling."""
        if self._mesh_bounds_cache is None:
            n_mesh = len(self.meshes)
            centers = np.zeros((n_mesh, 3), dtype=np.float32)
            extents = np.zeros((n_mesh, 3), dtype=np.float32)
            for idx, (_, V, _) in enumerate(self.meshes):
                if V.size == 0:
                    continue
                v = np.asarray(V, dtype=np.float32)
                vmin, vmax = v.min(axis=0), v.max(axis=0)
                centers[idx] = 0.5 * (vmin + vmax)
                extents[idx] = 0.5 * (vmax - vmin)
            self._mesh_bounds_cache = (centers, extents)
        return self._mesh_bounds_cache

    # -- device state -------------------------------------------------------

    def clear_device_cache(self) -> None:
        """Drop every device pack and flat table this solver holds; the host
        state stays."""
        self._scene_pack_cache.clear()
        self._emitter_pack_cache.clear()
        self._flat_cache.clear()

    def get_scene_pack(
        self, *, use_accel: bool = False, device=None
    ) -> ScenePack:
        """The scene pack on ``device`` (None: the default device, see
        ``_device_key``), one per physical device and accel flag however the
        device is spelled: at slim sizes a second copy of the resident pack
        would not fit beside the first."""
        dev = _device_key(device)
        key = (dev, bool(use_accel))
        if key not in self._scene_pack_cache:
            scene = self.get_scene(use_accel=use_accel)
            self._scene_pack_cache[key] = pack_scene(
                scene, len(self.meshes), device=torch.device(dev)
            )
        return self._scene_pack_cache[key]

    def get_flat_tables(
        self,
        *,
        samples: int,
        rays: int,
        flip_faces: bool,
        align: int = RAY_BLOCK,
        device=None,
    ):
        """Scene-wide flat ray tables and stacked geometry for scheduled solves.

        Concatenates every emitter's padded per-ray tables into 7 flat
        device tensors and stacks the per-emitter geometry padded to the
        largest face count ``F_max`` (the CDF padded with 1.0, which a
        left CDF search never selects past the last real face). Returns
        ``(tables_flat, geom_stacked, offsets, n_rays_pad)``: ``offsets[e]``
        is emitter e's first row in the flat tables, both NumPy int64.
        Built on the host, and uploaded once, unless some emitter's Halton
        tables were built on the device (``PreparedEmitter.dims_on``): then
        every table is padded and concatenated there, as the JAX package
        does past its device-Halton threshold. Bitwise the same either way.
        """
        dev = _device_key(device)
        key = (dev, int(samples), int(rays), bool(flip_faces), int(align))
        cached = self._flat_cache.get(key)
        if cached is not None:
            return cached

        emitters = self.get_emitters(samples=samples, rays=rays, flip_faces=flip_faces)
        n_pad = np.array(
            [_pad_rays(e.n_cells * rays, align) for e in emitters], dtype=np.int64
        )
        offsets = np.concatenate([[0], np.cumsum(n_pad)[:-1]]).astype(np.int64)
        dev_t = torch.device(dev)
        # per emitter: its u and v grids, then its five dimensions
        tables = [em.grids_on(dev_t) + em.dims_on(dev_t) for em in emitters]

        if any(isinstance(t, torch.Tensor) for em_tables in tables for t in em_tables):
            def flat(c: int) -> torch.Tensor:
                parts = []
                for e_idx, em_tables in enumerate(tables):
                    arr = _on(em_tables[c], dev_t)
                    if c < 2:
                        arr = torch.repeat_interleave(arr, rays)
                    parts.append(torch.nn.functional.pad(
                        arr, (0, int(n_pad[e_idx]) - arr.shape[0])))
                return torch.cat(parts)
        else:
            # all host tables: filled on the host and uploaded once a table,
            # not once an emitter (a district's 97 emitters: 7 uploads, not 679)
            def flat(c: int) -> torch.Tensor:
                out = np.zeros(int(n_pad.sum()), dtype=np.float32)
                for e_idx, em_tables in enumerate(tables):
                    arr = np.repeat(em_tables[c], rays) if c < 2 else em_tables[c]
                    out[offsets[e_idx] : offsets[e_idx] + arr.shape[0]] = arr
                return _put(out, dev_t)

        tables_flat = tuple(flat(c) for c in range(7))
        del tables

        f_max = max(em.cdf.shape[0] for em in emitters)

        def stack(get, tail=(), fill=0.0) -> torch.Tensor:
            out = np.full((len(emitters), f_max) + tail, fill, dtype=np.float32)
            for e_idx, em in enumerate(emitters):
                arr = get(em)
                out[e_idx, : arr.shape[0]] = arr
            return _put(out, dev_t)

        geom_stacked = (
            stack(lambda em: em.cdf, fill=1.0),
            stack(lambda em: em.tri_a, (3,)),
            stack(lambda em: em.tri_e1, (3,)),
            stack(lambda em: em.tri_e2, (3,)),
            stack(lambda em: em.tri_u, (3,)),
            stack(lambda em: em.tri_v, (3,)),
            stack(lambda em: em.tri_n, (3,)),
            stack(lambda em: em.tri_origin_eps),
        )
        cached = (tables_flat, geom_stacked, offsets, n_pad)
        self._flat_cache[key] = cached
        return cached

    def get_emitter_pack(
        self,
        index: int,
        *,
        samples: int,
        rays: int,
        flip_faces: bool,
        align: int = RAY_BLOCK,
        device=None,
    ) -> EmitterPack:
        dev = _device_key(device)
        key = (
            dev,
            int(index),
            int(samples),
            int(rays),
            bool(flip_faces),
            int(align),
        )
        if key not in self._emitter_pack_cache:
            emitter = self.get_emitter(
                index, samples=samples, rays=rays, flip_faces=flip_faces
            )
            self._emitter_pack_cache[key] = pack_emitter(
                emitter, rays, align=align, device=torch.device(dev)
            )
        return self._emitter_pack_cache[key]


__all__ = [
    "PreparedScene",
    "PreparedEmitter",
    "ScenePack",
    "EmitterPack",
    "LazyEmitterPack",
    "PreparedSolver",
    "prepare_scene",
    "prepare_emitters",
    "pack_scene",
    "pack_emitter",
    "morton_order",
    "pick_tri_tile",
]
