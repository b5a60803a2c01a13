"""Möller–Trumbore sweeps of rays against all triangles: the CUDA kernels'
wrappers, their plain PyTorch versions, the operand pack they consume and
the host side of their AABB distance gate.

Counterpart of ``raystrack_tpu/ops/trace_pallas.py``: ``sweep_rays``
(kernel #1, one emitter), ``sweep_rays_scheduled`` (kernel #2, each block
of 256 rays names its own emitter), their shared tile math ``_tile_step``
and the gate's tables (``_gate_tables``). Both kernels live in
``csrc/sweep_kernels.cuh``; the crossing pass of the gate's tables is a third
kernel, ``csrc/gate.cu`` (:func:`gate_cross`).

Layouts:

- rays ``(9, N)`` f32 rows ``[o | d | o x d]``,
- pack ``(24, Tpad)`` f32 rows: 0-2 cross_e, 3-5 e1, 6-8 e2, 9-11 v0 x e2,
  12-14 v0 x e1, 15 d0 = v0 . cross_e, 16 code_base = 2*sid, 17 mask_any,
  18 mask_mat, 19-23 zero,
- kernel #2's combined mask rows ``(E, Tpad)`` f32 ``m_any + m_mat`` in
  {0, 1, 2} (any-hit eligible if > 0, matrix eligible if > 1) and its
  ``emap`` ``(N / 256,)`` int32, the emitter row of each block of rays,
- outputs ``(N,)`` int32: the nearest eligible hit packed as
  ``2*sid + front`` (-1 on a miss), and a 0/1 any-hit flag.

Kernel #1 takes a triangle's eligibility in one of three mask modes
(:func:`_mask_mode`): from the pack's mask rows 17-18 (``rows``), from a
pack whose primary mask is baked into zeroed cross_e rows (``baked``), or
from the pack's code row against two scalars, ``code != emit_code`` for an
any-hit and also ``code >= min_code`` for the matrix (``code``: the slim
pack-resident mode, whose pack is built once per scene and never rewritten
per emitter).

Per-pair math and epsilons: ``|det| >= 1e-7``, ``t > 1e-6``,
``front = det > 0``. The nearest-hit fold runs over tiles of
``sweep_tile_width(Tpad, tri_tile)`` triangles: inside a tile the smallest
code wins among the triangles at the tile's minimum ``t``; across tiles only
a strictly smaller ``t`` replaces the carry. Tiles with no eligible triangle
(per emitter, for kernel #2) are skipped whole.

The gate (``accel=``, the scene's per-``ACCEL_GRAIN`` boxes): each block of
256 rays visits only the tiles whose box some of its rays statically cross,
nearest box first from the block's mean origin, and skips a tile when no
ray's margined slab interval can still improve its nearest hit or block it
anew. Past ``GATE_MAX_TILES`` tiles one box covers a group of consecutive
tiles. It is exact: only the visit order differs from the ungated sweep,
and that decides nothing but exact-``t`` ties across tiles.

On the card a block of 256 rays is served by one CTA or by two or four of
128 or 64 rays: ``split`` threads (1 to 16) share a ray's triangles inside
every sweep tile and merge by the tile's own tie rule, and each CTA walks
its block's visit list with its own votes over its own rays, so the result
depends on neither (:func:`sweep_split` picks the launch's
:class:`SweepGeometry` from its shape).
"""
from __future__ import annotations

import collections
import dataclasses
from functools import lru_cache
from typing import Optional, Tuple

import torch

from .. import config as _cfg
from .. import tracing as _tracing

INF = 1.0e20
TRI_ROWS = 24  # 19 used; the pack keeps the JAX package's row count

ROW_CE = 0
ROW_E1 = 3
ROW_E2 = 6
ROW_WU = 9
ROW_WV = 12
ROW_D0 = 15
ROW_CODE = 16
ROW_MASK_ANY = 17
ROW_MASK_MAT = 18

# Triangles per shared-memory stage of the kernel (csrc/sweep_kernels.cuh
# kStage); every sweep tile width is a multiple of it.
_STAGE = 128

# Rays per block of both kernels (csrc/sweep_kernels.cuh kRays): emap names one
# emitter per block of this many rays, and the gate decides per block, as
# the JAX package's ray_block.
RAY_SUBBLOCK = 256

# (B, T) pair elements per step of the plain versions: bounds their memory.
_REF_PAIRS = 1 << 22

# Empty-box padding of a two-level gate group: no slab test crosses it.
_EMPTY_BOX = 3.0e37


def sweep_tile_width(n_tri_pad: int, tri_tile: int) -> int:
    """The tile width the sweep uses: the requested width halved until it
    divides the padded triangle count."""
    tile = min(tri_tile, n_tri_pad)
    while tile > 128 and n_tri_pad % tile != 0:
        tile //= 2
    return tile


def build_tri_pack(scene: Tuple, m_any, m_mat, *, bake=None) -> torch.Tensor:
    """Assemble the (24, Tpad) f32 operand pack for one dispatch.

    ``scene`` is ``(v0, e1, e2, cross_e, w_u, w_v, d0, sid)``; ``m_any`` and
    ``m_mat`` are per-triangle bool masks. Padded triangles carry
    cross_e = 0, so det = 0 rejects them without any mask.

    With ``bake`` (a per-triangle bool mask) the cross_e rows of ineligible
    triangles are zeroed, so det = 0 rejects them like padding and the
    sweep can skip its per-pair test of that mask. Baking is result-exact.
    """
    v0, e1, e2, cross_e, w_u, w_v, d0, sid = scene
    if bake is not None:
        cross_e = torch.where(bake[:, None], cross_e, torch.zeros_like(cross_e))
    n = v0.shape[0]
    pack = torch.zeros((TRI_ROWS, n), dtype=torch.float32, device=v0.device)
    pack[ROW_CE:ROW_CE + 3] = cross_e.T
    pack[ROW_E1:ROW_E1 + 3] = e1.T
    pack[ROW_E2:ROW_E2 + 3] = e2.T
    pack[ROW_WU:ROW_WU + 3] = w_u.T
    pack[ROW_WV:ROW_WV + 3] = w_v.T
    pack[ROW_D0] = d0
    pack[ROW_CODE] = (sid * 2).to(torch.float32)
    pack[ROW_MASK_ANY] = m_any.to(torch.float32)
    pack[ROW_MASK_MAT] = m_mat.to(torch.float32)
    return pack


# ---------------------------------------------------------------------------
# The AABB distance gate: host side (trace_pallas.py gate_prunes,
# gate_group_size, _resolve_gate_window, _gate_loop_bound, _gate_tables)
# ---------------------------------------------------------------------------


def gate_group_size(n_tiles: int) -> int:
    """Tiles per gate box: 1 up to ``GATE_MAX_TILES`` tiles, then the
    smallest group that brings the box count back under it."""
    return -(-n_tiles // _cfg.GATE_MAX_TILES)


def gate_prunes(accel, n_tri_pad: int, tri_tile: int) -> bool:
    """Whether the sweeps gate this scene: it has acceleration boxes, more
    than one sweep tile (a single tile leaves nothing to skip) and a group
    size within ``GATE_MAX_GROUP``. Callers sort rays for coherence only
    then: the sort exists to make the gate fire."""
    if accel is None:
        return False
    n_tiles = n_tri_pad // sweep_tile_width(n_tri_pad, tri_tile)
    return n_tiles > 1 and gate_group_size(n_tiles) <= _cfg.GATE_MAX_GROUP


def _resolve_gate_window(gate_group: int) -> int:
    """Visit positions between early-exit checks (``GATE_WINDOW``: 8 or
    16), or 0 for none. Only the per-tile gate (group 1) exits early."""
    k = _cfg.GATE_WINDOW
    if gate_group != 1 or k <= 1:
        return 0
    return k if k in (8, 16) else 16


def _gate_loop_bound(n_tiles: int, gate_group: int) -> int:
    """Tile indices the gated loop can reach: whole groups, so ``tiles_on``
    is padded with inactive phantom tiles up to this bound."""
    return -(-n_tiles // gate_group) * gate_group


@dataclasses.dataclass(frozen=True)
class GateTables:
    """Per-call tables of the gate, on the rays' device.

    Block b (of ``ray_block`` rays) visits positions ``j < counts[b] *
    group``: box ``order[b, j // group]``, tile ``box * group + j % group``.
    At window starts (``j % window == 0``) it stops once every ray's nearest
    hit is at or below ``suffmin[b, j // window]`` (and has an any-hit, when
    those are wanted): no later box could then pass the gate.
    """

    boxes: torch.Tensor  # (n_boxes, 6) f32 [lo_x, lo_y, lo_z, hi_x, hi_y, hi_z]
    order: torch.Tensor  # (n_blocks, n_boxes) int32: crossed boxes first, near to far
    counts: torch.Tensor  # (n_blocks,) int32: boxes some ray of the block crosses
    suffmin: torch.Tensor  # (n_blocks, n_windows) f32; n_windows = 0 without window
    group: int
    window: int
    ray_block: int

    def blocks(self, idx: torch.Tensor) -> "GateTables":
        """The tables of the blocks ``idx``, in that order (a block's rows
        depend on its own rays only)."""
        return dataclasses.replace(
            self, order=self.order[idx], counts=self.counts[idx],
            suffmin=self.suffmin[idx])


# SMs of the card the port is written for (an H100 SXM): what a CPU tensor's
# plain version takes for the geometry its launch would have.
_H100_SMS = 132


@lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    if device.type != "cuda":
        return _H100_SMS
    return torch.cuda.get_device_properties(device).multi_processor_count


@dataclasses.dataclass(frozen=True)
class SweepGeometry:
    """How a launch lays its blocks of 256 rays (the gate's and ``emap``'s
    unit, the JAX package's ``ray_block``) onto CTAs: ``rays`` rays a CTA
    (256, 128 or 64: a block is ``256 // rays`` CTAs, CTA c serving rays
    ``[c * rays, (c + 1) * rays)``), ``split`` threads a ray (the kernels'
    ``kSplit``) and ``segments``, the contiguous parts a block's walk is cut
    into, each swept by a CTA of its own from a fresh carry and folded in
    order (the kernels cut an ungated launch's tiles; the plain versions a
    gated walk's visit positions too), and ``per_thread``, the rays a
    thread holds, each tested against every staged triangle the thread
    reads: a CTA is ``rays * split // per_thread`` threads. Every geometry
    gives the codes and flags of the 256-ray, one-segment walk."""

    rays: int = RAY_SUBBLOCK
    split: int = 1
    segments: int = 1
    per_thread: int = 1  # rays a thread holds (the kernels' kR)

    def units(self, n_rays: int) -> int:
        """CTAs (times segments) of a launch of ``n_rays`` rays: the rows
        of its per-CTA ``visits`` and ``timeline``."""
        return -(-n_rays // self.rays) * self.segments

    @property
    def per_block(self) -> int:
        """Rows of a block of 256 rays."""
        return RAY_SUBBLOCK // self.rays * self.segments

    @property
    def threads(self) -> int:
        """Threads of a CTA."""
        return self.rays * self.split // self.per_thread

    @property
    def name(self) -> str:
        """``"64x8"``: rays a CTA x threads a ray, ``"r4"`` after it for 4
        rays a thread and ``"s2"`` for 2 segments."""
        return (f"{self.rays}x{self.split}" + (f"r{self.per_thread}" if self.per_thread > 1 else "")
                + (f"s{self.segments}" if self.segments > 1 else ""))


# The geometries the kernels are built at (csrc/sweep.cuh
# RAYSTRACK_SWEEP_GEOMETRIES): a whole block a CTA at 1 or 4 threads a ray
# ungated and at 4 gated, one ray a thread (the geometry before CTAs served
# part of a block, which a test or measurement forces as a bare int: the
# splits of the whole-block CTA), and the geometries the rule picks.
UNGATED_SPLITS = (1, 4)
GATED_SPLIT = 4
BUILT_GEOMETRIES = {
    False: (SweepGeometry(RAY_SUBBLOCK, 1), SweepGeometry(RAY_SUBBLOCK, 4),
            SweepGeometry(RAY_SUBBLOCK, 2, 1, 4)) + tuple(
        SweepGeometry(RAY_SUBBLOCK, 8, g, 4) for g in range(1, 5)),
    True: (SweepGeometry(RAY_SUBBLOCK, GATED_SPLIT), SweepGeometry(64, 16, 1, 4)),
}
_SPLIT_BLOCKS_PER_SM = 4


def sweep_split(n_blocks: int, gated: bool, n_sms: int) -> SweepGeometry:
    """The geometry (:class:`SweepGeometry`) of a launch of ``n_blocks``
    blocks of 256 rays, gated or not, on a card of ``n_sms`` SMs: a pure
    function of the launch's shape.

    Every geometry it picks holds 4 rays a thread (up to 128 registers: a
    CTA of 128 threads fits an SM four times, one of 256 twice, one of 512
    once). Measured by ``chip_profile.py --splits`` and ``--launches
    --force-split`` on an NVIDIA H100 80GB HBM3 at 700 W, 132 SMs (ms,
    best of 3 and of 5):

    - Gated: 64 rays x 16 threads a ray x 4 rays a thread at every size. On
      the 1M city's ground -> city chunk, leading 32 / 132 / 192 / 264 / 528
      / 1,024 blocks: 64 x 16 r4 2.622 / 8.312 / 11.796 / 14.084 / 26.373 /
      45.618; 64 x 16 2.620 / 9.194 / 13.323 / 17.189 / 32.422 / 55.530;
      256 x 4 (whole blocks) 8.707 / 14.895 / 23.320 / 23.306 / 40.282 /
      57.773. The ``city_plates`` round (960 blocks): 64 x 16 r4 60.826, 64 x
      16 74.719, 256 x 4 85.098. The 3e7 city's chunk (192 blocks, the
      two-level gate): 141.211, 160.405, 282.913.
    - Ungated, up to four blocks an SM: whole blocks at 8 threads a ray and
      4 rays a thread (512 threads, one CTA an SM), cut into the 1-4 tile
      segments whose CTAs fill their last wave best (ties: the most). On
      the soup chunk's leading blocks (98,304 triangles), 256 x 8 r4 at the
      rule's segments / 256 x 4 / 256 x 1: 32 blocks 1.594 / 6.939 /
      11.828; 66: 3.168 / 6.948 / 11.841; 160: 7.888 / 13.860 / 15.670;
      192: 9.461 / 13.893 / 15.626; 200: 10.516 / 13.865 / 15.668; 300:
      14.599 / 20.629 / 21.805; 528: 25.017 / 27.511 / 28.681; the 3e7
      city's ungated chunk (192 blocks) 2,999.2 ms (256 x 4 4,522.5; 256 x
      1 5,097.7).
    - Ungated, past four blocks an SM: whole blocks at 2 threads a ray and 4
      rays a thread (128 threads), one segment: 256 x 8 r4's CTAs of 512
      threads each load their rays eight times and merge eight parts a
      tile, which a scene of one or two tiles pays at every block. Soup
      chunk (1,024 blocks) / soup8 round / ex06's row (6,144 blocks, a
      launch) / the canyon sky's round, any-only: 256 x 2 r4 49.714 /
      49.775 / 0.880 / 1.070; 256 x 4 r4 49.505 / 49.675 / 0.949 / 1.209;
      256 x 8 r4 50.407 / 51.374 / 1.080 / 1.521; 256 x 1 54.554 / 58.425 /
      0.893 / 1.117.
    """
    if n_blocks <= 0 or n_sms <= 0:
        return SweepGeometry(RAY_SUBBLOCK, 1)
    if gated:
        return SweepGeometry(64, 16, 1, 4)
    if n_blocks > _SPLIT_BLOCKS_PER_SM * n_sms:
        return SweepGeometry(RAY_SUBBLOCK, 2, 1, 4)

    def fill(segments):  # the CTAs' share of the waves' slots, one CTA an SM
        ctas = n_blocks * segments
        return ctas / (-(-ctas // n_sms) * n_sms)

    return SweepGeometry(RAY_SUBBLOCK, 8, max(range(1, 5), key=lambda g: (fill(g), g)), 4)


def _whole_block(n_blocks: int, gated: bool, n_sms: int) -> SweepGeometry:
    """The geometry the rule gave a launch of ``n_blocks`` blocks before CTAs
    served part of a block or held several rays a thread: a whole
    block a CTA, one segment, one ray a thread, at 4 threads a ray gated or
    up to four blocks an SM, else at 1."""
    if gated or n_blocks <= _SPLIT_BLOCKS_PER_SM * n_sms:
        return SweepGeometry(RAY_SUBBLOCK, 4)
    return SweepGeometry(RAY_SUBBLOCK, 1)


def _geometry(split) -> SweepGeometry:
    """A :class:`SweepGeometry` as it is, or a bare int ``k``: the whole
    256-ray block a CTA at ``k`` threads a ray, one segment (how a test or a
    measurement forces the geometry launches had before CTAs served part of
    a block)."""
    if isinstance(split, SweepGeometry):
        return split
    return SweepGeometry(RAY_SUBBLOCK, int(split))


def _ray_inv(dirs):
    """Per direction component: (|d| <= 1e-30, 1 / d, d >= 0), the slab
    test's ray terms (trace_pallas.py _ray_inv)."""
    out = []
    for d_c in dirs:
        d_zero = d_c.abs() <= 1e-30
        out.append((d_zero, torch.reciprocal(torch.where(d_zero, 1.0, d_c)), d_c >= 0.0))
    return out


def _box_interval(o, inv, lo, hi):
    """Margined ray-box slab interval (near_c, far_c), broadcast over the
    shapes of the per-axis ray terms ``o``/``inv`` and box bounds ``lo``/
    ``hi``. The relative margins keep it conservative against any faithful
    f32 evaluation, so the gate never drops a tile holding a better hit.
    The op order is the kernels' (csrc/gate.cuh slab_interval)."""
    near = far = None
    for c in range(3):
        d_zero, inv_c, d_pos = inv[c]
        t_n = (torch.where(d_pos, lo[c], hi[c]) - o[c]) * inv_c
        t_f = (torch.where(d_pos, hi[c], lo[c]) - o[c]) * inv_c
        inside = (o[c] >= lo[c]) & (o[c] <= hi[c])
        t_n = torch.where(d_zero, torch.where(inside, -INF, INF), t_n)
        t_f = torch.where(d_zero, torch.where(inside, INF, -INF), t_f)
        near = t_n if near is None else torch.maximum(near, t_n)
        far = t_f if far is None else torch.minimum(far, t_f)
    near_c = near - (near.abs() * 1e-4 + 1e-6)
    far_c = far + (far.abs() * 1e-4 + 1e-6)
    return near_c, far_c


def gate_cross_reference(rays: torch.Tensor, boxes: torch.Tensor,
                         ray_block: int = RAY_SUBBLOCK) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of the crossing kernel (``csrc/gate.cu``), the
    XLA code of ``trace_pallas.py`` ``_gate_tables`` (``block_union``): per
    block of ``ray_block`` rays of ``rays`` (9, N) and per box of ``boxes``
    (n_boxes, 6), ``crossed`` (n_blocks, n_boxes) bool, whether some ray of
    the block statically crosses the box (the kernel's slab test without the
    carry terms), and ``minnear`` (n_blocks, n_boxes) f32, the smallest near
    bound among the rays that do (``INF`` where none does). Rays past N in
    the last block cross nothing. The (rays, boxes) slab is built a few
    blocks at a time, so its steps stay near 4M elements."""
    device = rays.device
    n, n_boxes = rays.shape[1], boxes.shape[0]
    n_blocks = -(-n // ray_block)
    tail = n_blocks * ray_block - n
    o3 = torch.nn.functional.pad(rays[0:3], (0, tail), value=float("nan")).view(
        3, n_blocks, ray_block)
    d3 = torch.nn.functional.pad(rays[3:6], (0, tail), value=1.0).view(3, n_blocks, ray_block)
    crossed = torch.empty((n_blocks, n_boxes), dtype=torch.bool, device=device)
    minnear = torch.empty((n_blocks, n_boxes), dtype=torch.float32, device=device)
    lo_c = [boxes[None, :, c] for c in range(3)]
    hi_c = [boxes[None, :, 3 + c] for c in range(3)]
    per_step = max(1, min(n_blocks, _REF_PAIRS // max(ray_block * n_boxes, 1)))
    for b0 in range(0, n_blocks, per_step):
        b1 = min(n_blocks, b0 + per_step)
        ob = o3[:, b0:b1].reshape(3, -1, 1)
        inv = _ray_inv(d3[:, b0:b1].reshape(3, -1, 1))
        near_c, far_c = _box_interval(ob, inv, lo_c, hi_c)  # (rays, n_boxes)
        hit = ((far_c >= near_c) & (far_c > 1e-6)).view(b1 - b0, ray_block, n_boxes)
        crossed[b0:b1] = hit.any(dim=1)
        minnear[b0:b1] = torch.where(hit, near_c.view(hit.shape), INF).amin(dim=1)
    return crossed, minnear


def gate_cross(rays: torch.Tensor, boxes: torch.Tensor,
               ray_block: int = RAY_SUBBLOCK) -> Tuple[torch.Tensor, torch.Tensor]:
    """The crossing pass of the gate's tables: ``(crossed, minnear)`` as
    :func:`gate_cross_reference` defines them, bitwise (OR and minimum are
    exact in any order).

    CUDA tensors go to the kernel of ``csrc/gate.cu`` (one launch on the
    current stream, not synchronised; ``gate_cross.launches`` counts them);
    CPU tensors go to :func:`gate_cross_reference`.
    """
    for name, t in (("rays", rays), ("boxes", boxes)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor")
    if rays.dim() != 2 or boxes.dim() != 2:
        raise ValueError("rays must be (9, N) and boxes (n_boxes, 6)")
    device = rays.device
    n, n_boxes = int(rays.shape[1]), int(boxes.shape[0])
    _check("rays", rays, torch.float32, (9, n), device)
    _check("boxes", boxes, torch.float32, (n_boxes, 6), device)
    if ray_block < 1:
        raise ValueError(f"ray_block must be positive (got {ray_block})")
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"gate_cross runs on cuda or cpu tensors (got {device})")
    if n >= 2**31:
        raise ValueError("gate_cross takes fewer than 2**31 rays")
    if device.type == "cpu":
        return gate_cross_reference(rays, boxes, ray_block)

    from .build import load_library

    lib = load_library()
    n_blocks = -(-n // ray_block)
    crossed = torch.empty((n_blocks, n_boxes), dtype=torch.bool, device=device)
    minnear = torch.empty((n_blocks, n_boxes), dtype=torch.float32, device=device)
    if n == 0 or n_boxes == 0:  # nothing to launch
        return crossed, minnear
    with torch.cuda.device(device):
        err = lib.raystrack_gate_cross(
            rays.data_ptr(), n, boxes.data_ptr(), n_boxes, ray_block, crossed.data_ptr(),
            minnear.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    if err != 0:
        raise RuntimeError(f"gate crossing kernel launch failed: CUDA error {err}")
    gate_cross.launches += 1
    return crossed, minnear


gate_cross.launches = 0


def _gate_tables(accel, rays: torch.Tensor, n_tiles: int, tile: int, *,
                 window: int = 0, ray_block: int = RAY_SUBBLOCK) -> GateTables:
    """The gate's tables for one sweep of ``rays`` (9, N) over ``n_tiles``
    tiles of width ``tile``, on the rays' device.

    ``accel`` is the scene's (tile_lo, tile_hi) at ``ACCEL_GRAIN``
    granularity; boxes reduce to the tile width, then, past
    ``GATE_MAX_TILES`` tiles, to groups of consecutive tiles. Per block:
    the boxes some ray statically crosses (:func:`gate_cross`: one kernel on
    the card) sort first, by squared distance from the block's mean
    origin (a stable sort, as ``jnp.argsort``), and ``counts`` says how
    many; the suffix-min of the crossing rays' near bound over the visit
    order, read at window starts, is the early-exit bound. Rays past N in
    the last block cross nothing and do not move its mean. All but the
    crossing pass are tensor ops: a dozen launches, and the rounding of the
    block's mean (a 256-term sum) is what the JAX package's tables are held
    to.
    """
    device = rays.device
    per = tile // _cfg.ACCEL_GRAIN
    lo = accel[0].view(n_tiles, per, 3).amin(dim=1)
    hi = accel[1].view(n_tiles, per, 3).amax(dim=1)
    group = gate_group_size(n_tiles)
    n_boxes = -(-n_tiles // group)
    if group > 1:
        pad = n_boxes * group - n_tiles
        lo = torch.cat([lo, lo.new_full((pad, 3), _EMPTY_BOX)]).view(n_boxes, group, 3)
        hi = torch.cat([hi, hi.new_full((pad, 3), -_EMPTY_BOX)]).view(n_boxes, group, 3)
        lo, hi = lo.amin(dim=1), hi.amax(dim=1)
    boxes = torch.cat([lo, hi], dim=1).contiguous()

    n = rays.shape[1]
    n_blocks = -(-n // ray_block)
    tail = n_blocks * ray_block - n
    o3 = torch.nn.functional.pad(rays[0:3], (0, tail), value=float("nan")).view(
        3, n_blocks, ray_block)
    cent = o3.mean(dim=2).T  # (n_blocks, 3)
    if tail:
        cent[-1] = rays[0:3, (n_blocks - 1) * ray_block:].mean(dim=1)
    gap = torch.maximum(lo[None] - cent[:, None], cent[:, None] - hi[None]).clamp_min(0.0)
    dist2 = (gap * gap).sum(dim=2)  # (n_blocks, n_boxes)

    crossed, minnear = gate_cross(rays, boxes, ray_block)

    order = torch.argsort(torch.where(crossed, dist2, float("inf")), dim=1, stable=True)
    counts = crossed.sum(dim=1, dtype=torch.int32)
    if window:
        n_w = -(-n_boxes // window)
        mn = torch.nn.functional.pad(minnear.gather(1, order), (0, n_w * window - n_boxes),
                                     value=INF)
        suffix = mn.flip(1).cummin(dim=1).values.flip(1)
        suffmin = suffix[:, ::window].contiguous()
    else:
        suffmin = torch.empty((n_blocks, 0), dtype=torch.float32, device=device)
    return GateTables(
        boxes=boxes, order=order.to(torch.int32), counts=counts, suffmin=suffmin,
        group=group, window=window, ray_block=ray_block)


# ---------------------------------------------------------------------------
# Plain versions
# ---------------------------------------------------------------------------


# Kernel #1's mask modes, in the order of the C entry's ``mask_mode`` argument.
_MASK_MODES = ("rows", "baked", "code")

# The triangle splits, rays a CTA, rays a thread and segments the plain
# versions take: the kernels' splits, and 2, another partition the merge
# must be exact on; every part of a block of 256 rays down to 64; the
# kernels' rays a thread; any count of segments.
_SPLITS = (1, 2, 4, 8, 16)
_CTA_RAYS = (64, 128, RAY_SUBBLOCK)
_PER_THREAD = (1, 4)


def _check_geometry(geo: SweepGeometry) -> None:
    if (geo.split not in _SPLITS or geo.rays not in _CTA_RAYS or geo.segments < 1
            or geo.per_thread not in _PER_THREAD):
        raise ValueError(f"a plain sweep takes split in {_SPLITS}, rays a CTA in {_CTA_RAYS}, "
                         f"rays a thread in {_PER_THREAD} and segments >= 1 (got {geo})")


def _mask_mode(masks_baked: bool, code_bounds) -> str:
    """Kernel #1's mask mode, ``"rows"``, ``"baked"`` or ``"code"``, from the
    wrapper's two arguments (mutually exclusive, as in the JAX package)."""
    if code_bounds is not None and masks_baked:
        raise ValueError("masks_baked and code_bounds are mutually exclusive")
    return "code" if code_bounds is not None else "baked" if masks_baked else "rows"


def _code_bounds(code_bounds) -> Tuple[float, float]:
    """``(emit_code, min_code)`` as two host floats (both ``2 * sid``; they
    become kernel arguments, so a device tensor here would wait for the
    card)."""
    emit_code, min_code = code_bounds
    return float(emit_code), float(min_code)


def _eligibility(row, want_any: bool, mode: str, code_bounds):
    """One tile's per-triangle ``(m_any, m_mat)`` (..., 1, T) bool rows in
    mask mode ``mode``; None where every valid pair passes. A baked pack
    folds the primary mask (m_any when any-hits are wanted, else m_mat)
    into zeroed cross_e rows, so only the secondary m_mat test remains, and
    only when both outputs are wanted. In code mode triangles of a surface
    the emitter's plane cull switched off stay eligible: they lie behind
    the emission plane, so no ray can hit them. The kernel derives the same
    tests from its template arguments."""
    if mode == "code":
        code = row(ROW_CODE)
        not_emit = code != code_bounds[0]
        return not_emit, not_emit & (code >= code_bounds[1])
    if mode == "baked":
        return None, (row(ROW_MASK_MAT) > 0.0) if want_any else None
    return row(ROW_MASK_ANY) > 0.0, row(ROW_MASK_MAT) > 0.0


def _tile_step(rays, row, carry, *, want_matrix: bool, want_any: bool,
               mode: str = "rows", code_bounds=None, split: int = 1):
    """One tile of the sweep in tensor ops (trace_pallas.py _tile_step):
    ray columns ``rays`` (..., B, 1), operand rows ``row(r)`` (..., 1, T)
    and the carry (best_t, best_code, any_hit) (..., B, 1).

    Each product and sum rounds separately and ``t = t_num / det`` is an
    IEEE division, as in the kernel, so the two agree bitwise. With
    ``split`` > 1 the tile's triangles are partitioned as the kernel's
    ``kSplit`` threads of a ray partition them (part ``p`` takes triangles
    ``[p * 128 / split, (p + 1) * 128 / split)`` of every 128-triangle
    stage), each part reduces on its own and the parts merge by the tile's
    rule: the smallest ``t``, among equal ``t`` the smallest code, OR for
    the any-hit. That rule is a minimum in the order (t, code), so every
    ``split`` gives the same bits.
    """
    ox, oy, oz, dx, dy, dz, cx, cy, cz = rays
    best_t, best_code, any_hit = carry
    ce_x, ce_y, ce_z = row(ROW_CE), row(ROW_CE + 1), row(ROW_CE + 2)
    det = -(dx * ce_x + dy * ce_y + dz * ce_z)
    t_num = ox * ce_x + oy * ce_y + oz * ce_z - row(ROW_D0)
    u_num = (
        cx * row(ROW_E2) + cy * row(ROW_E2 + 1) + cz * row(ROW_E2 + 2)
        + dx * row(ROW_WU) + dy * row(ROW_WU + 1) + dz * row(ROW_WU + 2)
    )
    v_num = -(
        cx * row(ROW_E1) + cy * row(ROW_E1 + 1) + cz * row(ROW_E1 + 2)
        + dx * row(ROW_WV) + dy * row(ROW_WV + 1) + dz * row(ROW_WV + 2)
    )
    sign = torch.where(det >= 0.0, 1.0, -1.0)
    abs_det = det * sign
    un = u_num * sign
    vn = v_num * sign
    t_hit = t_num / det
    margin = torch.minimum(
        torch.minimum(abs_det - 1e-7, un),
        torch.minimum(vn, abs_det - (un + vn)),
    )
    valid = (margin >= 0.0) & (t_hit > 1e-6)
    m_any, m_mat = _eligibility(row, want_any, mode, code_bounds)

    def parts(x):
        """(..., B, T) -> (..., B, split, T / split): each part's triangles."""
        shape = x.shape[:-1] + (x.shape[-1] // _STAGE, split, _STAGE // split)
        return x.reshape(shape).transpose(-3, -2).flatten(-2)

    if want_any:
        blocked = valid if m_any is None else valid & m_any
        if split > 1:
            blocked = parts(blocked).any(dim=-1)  # (..., B, split): each part's flag
        any_hit = any_hit | blocked.any(dim=-1, keepdim=True)
    if want_matrix:
        mat_ok = valid if m_mat is None else valid & m_mat
        t_masked = torch.where(mat_ok, t_hit, INF)
        code_all = row(ROW_CODE).to(torch.int32) + (det > 0.0).to(torch.int32)
        if split > 1:  # each part's (t, code), then the merge across parts
            t_parts = parts(t_masked)
            part_best = t_parts.amin(dim=-1, keepdim=True)
            code_all = torch.where(t_parts == part_best, parts(code_all), 2**30).amin(dim=-1)
            t_masked = part_best.squeeze(-1)
        tile_best = t_masked.amin(dim=-1, keepdim=True)
        code = torch.where(t_masked == tile_best, code_all, 2**30).amin(dim=-1, keepdim=True)
        take = tile_best < best_t
        best_t = torch.where(take, tile_best, best_t)
        best_code = torch.where(take, code, best_code)
    return best_t, best_code, any_hit


def _fold_units(best_t, best_code, any_hit, segments: int):
    """Fold ``segments`` consecutive units' carries (the segments of one CTA,
    in order) into one, by the carry's own rule: only a strictly smaller t
    replaces it, the any-hit is an OR. (..., B, 1) tensors whose leading
    dimension is CTAs x segments."""
    if segments == 1:
        return best_t, best_code, any_hit
    t, c, a = (x.unflatten(0, (-1, segments)) for x in (best_t, best_code, any_hit))
    out_t, out_c, out_a = t[:, 0], c[:, 0], a[:, 0]
    for g in range(1, segments):
        take = t[:, g] < out_t
        out_t = torch.where(take, t[:, g], out_t)
        out_c = torch.where(take, c[:, g], out_c)
        out_a = out_a | a[:, g]
    return out_t, out_c, out_a


def _sweep_gated(rays, tri_pack, tiles_on, tile, gate: GateTables, geo: SweepGeometry, *,
                 want_matrix: bool, want_any: bool, mode: str, code_bounds=None):
    """The gated sweep in tensor ops: every unit of ``geo`` (a CTA's rays
    and one segment of its block's visit list) walks its part of the list
    as the gated kernel does (the same early-exit checks, the same per-box
    decision against its own rays' current carry, the same tiles_on skip
    and two-level indexing), all units in step, each visit running
    :func:`_tile_step` on the units that take it; then the segments fold in
    order. Returns (codes, flags, per-unit swept tiles, per-block swept
    tiles, per-unit (boxes listed, boxes walked)): a unit lists its block's
    boxes when it is a CTA's first segment, and walks each box whose first
    position it reaches before its part ends or a window stops it."""
    n = rays.shape[1]
    R, G = geo.rays, geo.segments
    per_cta = gate.ray_block // R
    n_blocks = gate.counts.shape[0]
    n_ctas = n_blocks * per_cta
    device = rays.device
    cols = torch.nn.functional.pad(rays, (0, n_blocks * gate.ray_block - n)).view(9, n_ctas, 1, R)
    cols = cols.expand(9, n_ctas, G, R).reshape(9, n_ctas * G, R, 1)
    U = n_ctas * G
    live = (torch.arange(n_ctas * R, device=device) < n).view(n_ctas, 1, R)
    live = live.expand(n_ctas, G, R).reshape(U, R, 1)
    blk = torch.arange(U, device=device) // (per_cta * G)  # the block each unit serves
    seg = torch.arange(U, device=device) % G
    inv = _ray_inv(cols[3:6])
    best_t = torch.full((U, R, 1), INF, dtype=torch.float32, device=device)
    best_code = torch.full((U, R, 1), -1, dtype=torch.int32, device=device)
    any_hit = torch.zeros((U, R, 1), dtype=torch.bool, device=device)
    n_visit = gate.counts.long()[blk] * gate.group
    seg_len = -(-n_visit // G)
    lo, hi = seg * seg_len, torch.minimum((seg + 1) * seg_len, n_visit)
    order, suffmin = gate.order[blk], gate.suffmin[blk]
    done = torch.zeros(U, dtype=torch.bool, device=device)
    n_done = torch.zeros(U, dtype=torch.int32, device=device)
    walked = torch.zeros(U, dtype=torch.int64, device=device)
    block_done = torch.zeros(n_blocks, dtype=torch.int32, device=device)
    lanes = torch.arange(tile, device=device)
    step = max(1, _REF_PAIRS // (R * tile))
    kw = dict(want_matrix=want_matrix, want_any=want_any, mode=mode, code_bounds=code_bounds,
              split=geo.split)
    for j in range(int(hi.max()) if U else 0):
        act = (lo <= j) & (hi > j) & ~done
        if gate.window and j % gate.window == 0:
            settled = best_t <= suffmin[:, j // gate.window, None, None]
            if want_any:
                settled &= any_hit
            stop = act & (settled | ~live).all(dim=2).all(dim=1)
            done |= stop
            act &= ~stop
        if j % gate.group == 0:
            walked += act
        box = order[:, j // gate.group].long()
        it = box * gate.group + j % gate.group
        act &= tiles_on[it] > 0
        unit = act.nonzero().squeeze(1)
        if unit.numel() == 0:
            continue
        sub = lambda t: t.index_select(0, unit)  # noqa: E731, B023
        bx = gate.boxes.index_select(0, box.index_select(0, unit))[:, :, None, None]
        near_c, far_c = _box_interval(
            [sub(cols[c]) for c in range(3)], [tuple(map(sub, v)) for v in inv],
            [bx[:, c] for c in range(3)], [bx[:, 3 + c] for c in range(3)])
        hit = (far_c >= near_c) & (far_c > 1e-6)
        need = torch.zeros_like(hit)
        if want_matrix:
            need = hit & (near_c < sub(best_t))
        if want_any:
            need = need | (hit & ~sub(any_hit))
        unit = unit[(need & sub(live)).any(dim=2).any(dim=1)]
        n_done.index_add_(0, unit, torch.ones_like(unit, dtype=torch.int32))
        # at step j all units of a block stand on one tile: count it once
        block_done += torch.zeros_like(block_done).index_fill_(0, blk.index_select(0, unit), 1)
        for k0 in range(0, unit.numel(), step):
            kb = unit[k0 : k0 + step]
            idx = it.index_select(0, kb)[:, None] * tile + lanes  # (K, T)
            tri = tri_pack[:, idx]  # (24, K, T)
            row = lambda r: tri[r][:, None, :]  # noqa: E731, B023 - (K, 1, T)
            carry = tuple(c.index_select(0, kb) for c in (best_t, best_code, any_hit))
            new = _tile_step([cols[c].index_select(0, kb) for c in range(9)], row, carry, **kw)
            for c, v in zip((best_t, best_code, any_hit), new):
                c.index_copy_(0, kb, v)
    best_t, best_code, any_hit = _fold_units(best_t, best_code, any_hit, G)
    codes = torch.where(best_t < INF, best_code, -1).view(-1)[:n]
    listed = torch.where(seg == 0, gate.counts.long()[blk], 0)
    walk = torch.stack([listed, walked], dim=1)[: geo.units(n)]
    return codes, any_hit.view(-1)[:n].to(torch.int32), n_done[: geo.units(n)], block_done, walk


def _store_visits(visits: Optional[torch.Tensor], n: int, geo: SweepGeometry, per_unit,
                  per_block) -> None:
    """Write a sweep's visit counts into the caller's ``visits``: one row per
    unit of ``geo`` (CTA x segment), the tiles each swept; or one row per
    block of 256 rays, the tiles any of the block's units swept, which is
    the 256-ray, one-segment walk's count at every geometry of one segment
    (a CTA's rays keep the carries that walk gives them, so the CTAs
    together sweep the tiles some ray of the block needs; a gated segment
    after the first starts from a fresh carry and may sweep more)."""
    if visits is None:
        return
    if visits.shape[0] == geo.units(n):
        visits.copy_(per_unit)
    elif visits.shape[0] == -(-n // RAY_SUBBLOCK):
        visits.copy_(per_block)
    else:
        raise ValueError(f"visits must have one row per block of {RAY_SUBBLOCK} rays "
                         f"({-(-n // RAY_SUBBLOCK)}) or per unit of {geo} ({geo.units(n)}); "
                         f"got {visits.shape[0]}")


def _count_work(per_unit: torch.Tensor, walk: torch.Tensor, n: int, geo: SweepGeometry,
                tile: int) -> None:
    """A plain sweep's ``tiles_swept``, ``pairs_tested``, ``boxes_listed``
    and ``boxes_walked`` (``tracing``) from its per-unit visits and (boxes
    listed, boxes walked), as the kernels count theirs: each unit's tiles,
    times the tile's triangles and the rays below ``n`` of its CTA."""
    if not _tracing.on():
        return
    units = per_unit.long().cpu()
    below = n - torch.arange(units.shape[0]) // geo.segments * geo.rays
    listed, walked = walk.sum(dim=0).tolist()
    _tracing.add(tiles_swept=int(units.sum()),
                 pairs_tested=int((units * below.clamp(max=geo.rays)).sum()) * tile,
                 boxes_listed=listed, boxes_walked=walked)


def _count_launch(n: int, geo: SweepGeometry, n_tiles: int) -> None:
    """A sweep launch's ``rays_padded`` and ``tiles_offered`` (``tracing``):
    its rays, and its CTAs of rays times its tiles (the tile segments of a
    CTA's rays share them)."""
    if _tracing.on():
        _tracing.add(rays_padded=n, tiles_offered=-(-n // geo.rays) * n_tiles)


def _fold_timeline(rows: torch.Tensor, out: torch.Tensor, geo: SweepGeometry) -> None:
    """A per-block timeline ``out`` (blocks, 4) from the launch's per-CTA
    ``rows``: the earliest start, the latest end, the SM of the block's
    first CTA, the most visit positions one of its CTAs walked."""
    per, n_blocks = geo.per_block, out.shape[0]
    pad = n_blocks * per - rows.shape[0]
    r = torch.cat([rows, rows.new_zeros((pad, 4))]).view(n_blocks, per, 4)
    start = torch.cat([rows[:, 0], rows.new_full((pad,), torch.iinfo(rows.dtype).max)])
    out[:, 0] = start.view(n_blocks, per).amin(dim=1)
    out[:, 1] = r[:, :, 1].amax(dim=1)
    out[:, 2] = r[:, 0, 2]
    out[:, 3] = r[:, :, 3].amax(dim=1)


def _sweep_plain(rays, tri_pack, tiles_on, tile, geo: SweepGeometry, *, gate, **kw):
    """Kernel #1's plain sweep at ``geo``: (codes, flags, tiles each unit
    swept, tiles each block's units swept, each unit's (boxes listed, boxes
    walked), zero ungated)."""
    if gate is not None:
        return _sweep_gated(rays, tri_pack, tiles_on, tile, gate, geo, **kw)
    n = rays.shape[1]
    device = rays.device
    codes = torch.full((n,), -1, dtype=torch.int32, device=device)
    any_out = torch.zeros((n,), dtype=torch.int32, device=device)
    n_tiles = tiles_on.shape[0]
    seg_len = -(-n_tiles // geo.segments)
    on = tiles_on.tolist()
    segments = [[i for i in range(g * seg_len, min((g + 1) * seg_len, n_tiles)) if on[i]]
                for g in range(geo.segments)]
    per_unit = torch.tensor([len(t) for t in segments], dtype=torch.int32,
                            device=device).repeat(geo.units(n) // geo.segments)
    per_block = torch.full((-(-n // RAY_SUBBLOCK),), sum(map(len, segments)), dtype=torch.int32,
                           device=device)
    chunk = max(1, _REF_PAIRS // tile)
    for r0 in range(0, n, chunk):
        ray_cols = [rays[j, r0 : r0 + chunk, None] for j in range(9)]
        b = ray_cols[0].shape[0]
        carries = []
        for active in segments:
            carry = (
                torch.full((b, 1), INF, dtype=torch.float32, device=device),
                torch.full((b, 1), -1, dtype=torch.int32, device=device),
                torch.zeros((b, 1), dtype=torch.bool, device=device),
            )
            for i in active:
                tri = tri_pack[:, i * tile : (i + 1) * tile]
                carry = _tile_step(ray_cols, lambda r: tri[r : r + 1], carry,  # noqa: B023
                                   split=geo.split, **kw)
            carries.append(carry)
        best_t, best_code, any_hit = _fold_units(
            *(torch.stack(x, dim=1).flatten(0, 1) for x in zip(*carries)), geo.segments)
        codes[r0 : r0 + b] = torch.where(best_t < INF, best_code, -1)[:, 0]
        any_out[r0 : r0 + b] = any_hit[:, 0].to(torch.int32)
    walk = torch.zeros((geo.units(n), 2), dtype=torch.int64, device=device)
    return codes, any_out, per_unit, per_block, walk


def sweep_rays_reference(
    rays: torch.Tensor,
    tri_pack: torch.Tensor,
    tiles_on: torch.Tensor,
    tile: int,
    *,
    want_matrix: bool,
    want_any: bool,
    masks_baked: bool = False,
    code_bounds=None,
    gate: Optional[GateTables] = None,
    visits: Optional[torch.Tensor] = None,
    split=1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel #1: :func:`_tile_step` over triangle
    tiles of width ``tile``, skipping tiles whose ``tiles_on`` flag is 0, in
    the mask mode ``masks_baked`` / ``code_bounds`` name (:func:`_mask_mode`).

    ``split`` is the launch's geometry: a :class:`SweepGeometry`, or a bare
    int, the threads a ray of a whole 256-ray block a CTA (1, 2, 4, 8 or 16;
    the kernels are built at :data:`BUILT_GEOMETRIES`). The split partitions
    each tile's triangles as the kernel's ``kSplit`` threads of a ray do and
    merges the parts by the tile's tie rule (:func:`_tile_step`); each CTA
    of ``rays`` rays votes over its own rays; each segment sweeps its part
    of the tiles (ungated: of the tile indices; gated: of the block's visit
    positions) from a fresh carry, and the segments fold in order by the
    carry's rule: the same codes and flags at every geometry.

    Ungated, every ray takes the active tiles in order, in ray chunks that
    bound its memory. With ``gate`` (:func:`_gate_tables` of these rays;
    ``tiles_on`` padded to :func:`_gate_loop_bound`) each CTA walks its
    block's visit list as the gated kernel does. ``visits``, an int32
    tensor of one row per unit of the geometry (``split.units(N)``: CTAs x
    segments) or one per block of 256 rays, receives the tiles each unit
    swept, or the tiles any unit of each block swept: the 256-ray,
    one-segment walk's count at every geometry of one segment
    (:func:`_store_visits`; a test and measurement aid, as in the kernel).
    ``split``'s ``per_thread`` (the rays a kernel thread holds) changes
    nothing here: each ray's carry is its own.
    """
    geo = _geometry(split)
    _check_geometry(geo)
    codes, any_out, per_unit, per_block, walk = _sweep_plain(
        rays, tri_pack, tiles_on, tile, geo, gate=gate, want_matrix=want_matrix,
        want_any=want_any, mode=_mask_mode(masks_baked, code_bounds),
        code_bounds=None if code_bounds is None else _code_bounds(code_bounds))
    _store_visits(visits, rays.shape[1], geo, per_unit, per_block)
    _count_work(per_unit, walk, rays.shape[1], geo, tile)
    return codes, any_out


def _check(name: str, t: torch.Tensor, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if t.dtype != dtype:
        raise TypeError(f"{name} must be {dtype} (got {t.dtype})")
    if tuple(t.shape) != shape:
        raise ValueError(f"{name} must have shape {shape} (got {tuple(t.shape)})")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, rays are on {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def _check_common(rays, tri_pack, want_matrix: bool, want_any: bool,
                  tri_tile: int, name: str, **others) -> Tuple[torch.device, int, int, int]:
    """Checks both wrappers share; returns (device, N, Tpad, tile)."""
    if not (want_matrix or want_any):
        raise ValueError(f"{name} needs want_matrix or want_any")
    for arg, t in (("rays", rays), ("tri_pack", tri_pack), *others.items()):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{arg} must be a torch.Tensor")
    if rays.dim() != 2 or tri_pack.dim() != 2:
        raise ValueError("rays must be (9, N) and tri_pack (24, Tpad)")
    device = rays.device
    n, n_tri_pad = int(rays.shape[1]), int(tri_pack.shape[1])
    _check("rays", rays, torch.float32, (9, n), device)
    _check("tri_pack", tri_pack, torch.float32, (TRI_ROWS, n_tri_pad), device)
    tile = sweep_tile_width(n_tri_pad, tri_tile)
    if n_tri_pad == 0 or tile % _STAGE or n_tri_pad % tile:
        raise ValueError(
            f"sweep tile {tile} (from tri_tile={tri_tile}) must be a multiple of "
            f"{_STAGE} dividing the pack width {n_tri_pad}"
        )
    if device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name} runs on cuda or cpu tensors (got {device})")
    if n >= 2**31 or n_tri_pad >= 2**31:
        raise ValueError(f"{name} takes fewer than 2**31 rays and triangles")
    return device, n, n_tri_pad, tile


def _gate_for(accel, rays: torch.Tensor, n_tri_pad: int, tile: int, tri_tile: int,
              device: torch.device) -> Optional[GateTables]:
    """The gate's tables when the sweep is gated (:func:`gate_prunes`, as
    ``trace_pallas.py`` decides ``use_gate``), else None."""
    if not gate_prunes(accel, n_tri_pad, tri_tile) or rays.shape[1] == 0:
        return None
    if not isinstance(accel, (tuple, list)) or len(accel) != 2:
        raise TypeError("accel must be the scene's (tile_lo, tile_hi) pair")
    grains = n_tri_pad // _cfg.ACCEL_GRAIN
    for name, t in zip(("tile_lo", "tile_hi"), accel):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"accel {name} must be a torch.Tensor")
        _check(f"accel {name}", t, torch.float32, (grains, 3), device)
    n_tiles = n_tri_pad // tile
    with _tracing.span("raystrack.ops.gate"):
        return _gate_tables(accel, rays, n_tiles, tile,
                            window=_resolve_gate_window(gate_group_size(n_tiles)))


def _gated_tiles_on(tiles_on: torch.Tensor, gate: Optional[GateTables]) -> torch.Tensor:
    """``tiles_on`` (..., n_tiles) padded with inactive phantom tiles up to
    :func:`_gate_loop_bound`, which whole gate groups reach."""
    if gate is None:
        return tiles_on
    n_tiles = tiles_on.shape[-1]
    extra = _gate_loop_bound(n_tiles, gate.group) - n_tiles
    return torch.nn.functional.pad(tiles_on, (0, extra)).contiguous()


def _check_visits(visits, n: int, device: torch.device, geo: SweepGeometry, timeline=None,
                  gated: bool = False) -> None:
    """``visits`` (int32) and ``timeline`` ((rows, 4) int64, gated card
    sweeps only) take one row per block of 256 rays or one per unit of the
    launch's geometry (``geo.units(n)``; the same where a CTA serves a
    whole block)."""
    rows = {-(-n // RAY_SUBBLOCK), geo.units(n)}
    if visits is not None:
        if not isinstance(visits, torch.Tensor):
            raise TypeError("visits must be a torch.Tensor")
        if visits.dim() != 1 or visits.shape[0] not in rows:
            raise ValueError(f"visits must have one row per block or per CTA, {sorted(rows)} "
                             f"(got {tuple(visits.shape)})")
        _check("visits", visits, torch.int32, tuple(visits.shape), device)
    if timeline is not None:
        if not isinstance(timeline, torch.Tensor):
            raise TypeError("timeline must be a torch.Tensor")
        if device.type != "cuda" or not gated:
            raise ValueError("timeline is the gated kernels' output: it needs cuda tensors "
                             "and a gated sweep")
        if timeline.dim() != 2 or timeline.shape[0] not in rows:
            raise ValueError(f"timeline must have one row per block or per CTA, {sorted(rows)} "
                             f"(got {tuple(timeline.shape)})")
        _check("timeline", timeline, torch.int64, (timeline.shape[0], 4), device)


def _launch_geometry(n: int, gated: bool, device: torch.device) -> SweepGeometry:
    """The geometry of a sweep of ``n`` rays on ``device``: the rule's
    (:func:`sweep_split`) on this card, or on an H100 for a CPU tensor."""
    return _geometry(sweep_split(-(-n // RAY_SUBBLOCK), gated, _sm_count(device)))


def _gate_args(gate: Optional[GateTables], geo: SweepGeometry, n: int,
               device: torch.device) -> tuple:
    """The C entries' gate arguments, table pointers and sizes (NULL
    pointers for an ungated sweep), then the geometry: threads a ray, rays
    a CTA, tile segments, rays a thread and, past one segment, their
    partial results' buffers (kept alive by the tensors returned with the
    arguments)."""
    if gate is not None and geo.segments != 1:
        raise ValueError(f"a gated sweep runs one segment (got {geo.segments}): a later "
                         f"segment would start without the carry the gate's votes need")
    parts = ()
    ptrs = (None, None, None)
    if geo.segments > 1:
        parts = (torch.empty((geo.segments, n), dtype=torch.float32, device=device),
                 *(torch.empty((geo.segments, n), dtype=torch.int32, device=device)
                   for _ in range(2)))
        ptrs = tuple(t.data_ptr() for t in parts)
    shape = (geo.split, geo.rays, geo.segments, geo.per_thread, *ptrs)
    if gate is None:
        return (None, None, None, None, 0, 1, 0, 0, *shape), parts
    return (gate.boxes.data_ptr(), gate.order.data_ptr(), gate.counts.data_ptr(),
            gate.suffmin.data_ptr(), int(gate.boxes.shape[0]),
            gate.group, gate.window, int(gate.suffmin.shape[1]), *shape), parts


def _debug_args(visits, timeline, n: int, geo: SweepGeometry, n_tiles: int,
                device: torch.device):
    """The C entries' visit, work and timeline arguments for the caller's
    ``visits`` and ``timeline`` (each one row per block of 256 rays or one
    per CTA; :func:`_store_visits`) and, while tracing is on, the work
    counters of ``device`` (``tracing.device_work``), what folds a per-CTA
    timeline into the caller's per-block one after the launch, and the
    buffers the arguments
    point into, which the caller holds until the launch is enqueued (freed
    earlier, the allocator would hand their memory to the next buffer the
    launch writes). A per-block count at a geometry of several CTAs a block
    is tallied in the kernel through a zeroed bitmap of the tiles
    (``n_tiles``, phantoms included) per block."""
    n_blocks, n_units = -(-n // RAY_SUBBLOCK), geo.units(n)
    cta = block = swept = None
    words = 0
    if visits is not None:
        if visits.shape[0] == n_units:
            cta = visits
        else:
            block = visits.zero_()
            words = -(-n_tiles // 32)
            swept = torch.zeros((n_blocks, words), dtype=torch.int32, device=visits.device)
    rows = timeline
    if timeline is not None and timeline.shape[0] != n_units:
        rows = torch.zeros((n_units, 4), dtype=torch.int64, device=timeline.device)

    work = _tracing.device_work(device) if _tracing.on() else None

    def fold():
        if rows is not timeline:
            _fold_timeline(rows, timeline, geo)

    return ((_ptr(cta), _ptr(block), _ptr(swept), words, _ptr(work), _ptr(rows)), fold,
            (swept, rows))


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def sweep_rays(
    rays: torch.Tensor,  # (9, N) f32: [o | d | o x d] rows
    tri_pack: torch.Tensor,  # (24, Tpad) f32
    sweep_mask: torch.Tensor,  # (Tpad,) bool: triangles this sweep may touch
    *,
    tri_tile: int,
    want_matrix: bool,
    want_any: bool,
    masks_baked: bool = False,
    code_bounds=None,
    accel=None,
    visits: Optional[torch.Tensor] = None,
    timeline: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Sweep all rays against all triangles; returns (codes (N,), any (N,)).

    ``masks_baked`` promises the pack was built with :func:`build_tri_pack`'s
    ``bake`` option, letting the sweep drop per-pair tests of that mask.
    ``code_bounds``, a pair of host floats ``(emit_code, min_code)``, both
    ``2 * sid``, instead takes per-pair eligibility from the pack's code
    row: the slim pack-resident mode, whose pack (``ScenePack.tri_pack``)
    is built once per scene with zero mask rows; ``sweep_mask`` then only
    decides the tiles to skip. The two are mutually exclusive.
    ``accel``, the scene's ``(tile_lo, tile_hi)``, gates the sweep where
    :func:`gate_prunes` (pair it with ``ops.trace.sort_rays_for_coherence``:
    gating is exact either way, but only coherent blocks make it fire).
    ``visits``, an int32 tensor of one row per CTA of the launch's geometry
    (``sweep_split(...).units(N)``), receives the number of tiles each CTA
    swept; of one row per block of 256 rays, the tiles any CTA serving the
    block swept: the 256-ray walk's count at every geometry (at a whole
    block a CTA, the two are the same).
    ``timeline``, a (rows, 4) int64 tensor of the same rows (gated sweeps
    on the card only), receives each CTA's start and end on the card's
    nanosecond timer, its SM and the visit positions it walked, or per
    block the first start, the last end, its first CTA's SM and the most
    positions a CTA walked.

    CUDA tensors go to kernel #1 of ``csrc/sweep_kernels.cuh``, at the
    geometry :func:`sweep_split` gives for the launch's shape (launched on
    the current stream, not synchronised; ``sweep_rays.launches`` counts the
    launches, ``sweep_rays.gated_launches`` the gated ones,
    ``sweep_rays.code_launches`` those in code mode and
    ``sweep_rays.geometries`` each geometry's); CPU tensors go to
    :func:`sweep_rays_reference` at the geometry an H100 launch of their
    shape would take. While a profiler records (``tracing``), the call is
    the span ``raystrack.ops.sweep`` (the gate's tables before it,
    ``raystrack.ops.gate``) and adds to the work counters: its rays and
    tiles offered here, the tiles swept and pairs tested in the kernel (or
    the plain version).
    """
    device, n, n_tri_pad, tile = _check_common(
        rays, tri_pack, want_matrix, want_any, tri_tile, "sweep_rays",
        sweep_mask=sweep_mask,
    )
    _check("sweep_mask", sweep_mask, torch.bool, (n_tri_pad,), device)
    mode = _mask_mode(masks_baked, code_bounds)
    emit_code, min_code = _code_bounds(code_bounds) if mode == "code" else (0.0, 0.0)
    gate = _gate_for(accel, rays, n_tri_pad, tile, tri_tile, device)
    with _tracing.span("raystrack.ops.sweep"):
        geo = _launch_geometry(n, gate is not None, device)
        _check_visits(visits, n, device, geo, timeline, gate is not None)
        _count_launch(n, geo, n_tri_pad // tile)
        tiles_on = _gated_tiles_on(
            sweep_mask.reshape(-1, tile).any(dim=1).to(torch.int32), gate)

        if device.type == "cpu":
            return sweep_rays_reference(
                rays, tri_pack, tiles_on, tile, want_matrix=want_matrix,
                want_any=want_any, masks_baked=masks_baked, code_bounds=code_bounds,
                gate=gate, visits=visits, split=geo,
            )

        from .build import load_library

        lib = load_library()
        codes = torch.empty((n,), dtype=torch.int32, device=device)
        any_hit = torch.empty((n,), dtype=torch.int32, device=device)
        if n == 0:  # nothing to launch
            return codes, any_hit
        debug, fold, _held = _debug_args(visits, timeline, n, geo, int(tiles_on.shape[0]),
                                         device)
        shape, _parts = _gate_args(gate, geo, n, device)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = lib.raystrack_sweep_rays(
                rays.data_ptr(), n, tri_pack.data_ptr(), n_tri_pad,
                tiles_on.data_ptr(), tile,
                int(want_matrix), int(want_any), _MASK_MODES.index(mode), emit_code, min_code,
                *shape, codes.data_ptr(), any_hit.data_ptr(), *debug, stream,
            )
        if err != 0:
            raise RuntimeError(f"sweep kernel launch failed: CUDA error {err}")
        fold()
        sweep_rays.launches += 1
        sweep_rays.gated_launches += gate is not None
        sweep_rays.code_launches += mode == "code"
        sweep_rays.geometries[geo.name] += 1
        return codes, any_hit


sweep_rays.launches = 0
sweep_rays.gated_launches = 0
sweep_rays.code_launches = 0
sweep_rays.geometries = collections.Counter()  # launches by geometry name


def scheduled_tiles_on(masks: torch.Tensor, tile: int, *, want_matrix: bool,
                       want_any: bool) -> torch.Tensor:
    """(E, n_tiles) int32 per-emitter tile activity of kernel #2: a tile is
    on for emitter e when its row holds a triangle eligible for what the
    sweep computes (> 1 for matrix only, > 0 when any-hits are wanted)."""
    thresh = 1.0 if (want_matrix and not want_any) else 0.0
    n_emit, n_tri_pad = masks.shape
    return (masks.view(n_emit, n_tri_pad // tile, tile) > thresh).any(dim=2).to(torch.int32)


def sweep_rays_scheduled_reference(
    rays: torch.Tensor,
    tri_pack: torch.Tensor,
    masks: torch.Tensor,
    emap: torch.Tensor,
    tiles_on: torch.Tensor,
    tile: int,
    *,
    want_matrix: bool,
    want_any: bool,
    gate: Optional[GateTables] = None,
    visits: Optional[torch.Tensor] = None,
    split=1,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch version of kernel #2: per emitter row named in
    ``emap``, its blocks of rays are swept by :func:`sweep_rays_reference`
    (the same pair math and tie rule, and with ``gate`` those blocks' rows
    of the gate tables) against the pack with that emitter's combined row
    written into the mask rows (``> 0`` any, ``> 1`` matrix) and that
    emitter's row of ``tiles_on``. A block whose row lies outside
    ``0..E-1`` sweeps nothing (-1 and 0, no visit), as in the kernel.
    ``split`` (the geometry) and ``visits`` are :func:`sweep_rays_reference`'s."""
    n = rays.shape[1]
    geo = _geometry(split)
    _check_geometry(geo)
    device = rays.device
    codes = torch.full((n,), -1, dtype=torch.int32, device=device)
    any_out = torch.zeros((n,), dtype=torch.int32, device=device)
    per_unit = torch.zeros(geo.units(n), dtype=torch.int32, device=device)
    per_block = torch.zeros(n // RAY_SUBBLOCK, dtype=torch.int32, device=device)
    walk = torch.zeros((geo.units(n), 2), dtype=torch.int64, device=device)
    per = geo.per_block
    for e in torch.unique(emap).tolist():
        if not 0 <= e < masks.shape[0]:
            continue
        blocks = torch.nonzero(emap == e).squeeze(1)
        idx = (blocks[:, None] * RAY_SUBBLOCK
               + torch.arange(RAY_SUBBLOCK, device=device)).reshape(-1)
        pack = tri_pack.clone()
        pack[ROW_MASK_ANY] = (masks[e] > 0.0).to(torch.float32)
        pack[ROW_MASK_MAT] = (masks[e] > 1.0).to(torch.float32)
        c, a, units, block, unit_walk = _sweep_plain(
            rays.index_select(1, idx).contiguous(), pack, tiles_on[e], tile, geo,
            gate=None if gate is None else gate.blocks(blocks), want_matrix=want_matrix,
            want_any=want_any, mode="rows")
        codes[idx] = c
        any_out[idx] = a
        rows = (blocks[:, None] * per + torch.arange(per, device=device)).reshape(-1)
        per_unit[rows] = units
        walk[rows] = unit_walk
        per_block[blocks] = block
    _store_visits(visits, n, geo, per_unit, per_block)
    _count_work(per_unit, walk, n, geo, tile)
    return codes, any_out


def sweep_rays_scheduled(
    rays: torch.Tensor,  # (9, N) f32: [o | d | o x d] rows, N = 256 * n_blocks
    tri_pack: torch.Tensor,  # (24, Tpad) f32; its mask rows are not read
    masks: torch.Tensor,  # (E, Tpad) f32 combined rows m_any + m_mat
    emap: torch.Tensor,  # (N / 256,) i32: block of 256 rays -> emitter row
    *,
    tri_tile: int,
    want_matrix: bool,
    want_any: bool,
    accel=None,
    visits: Optional[torch.Tensor] = None,
    timeline: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Multi-emitter sweep; returns (codes (N,), any (N,)).

    Each block of 256 rays is swept for the emitter row ``emap`` names:
    its eligibility comes from that row of ``masks`` and whole tiles with
    no eligible triangle for that emitter are skipped. Per ray the result
    equals :func:`sweep_rays` with that emitter's masks. A block whose row
    lies outside ``0..E-1`` sweeps nothing (codes -1, any 0): reading
    ``emap`` on the host would wait for the card. ``accel``, ``visits`` and
    ``timeline`` are :func:`sweep_rays`'.

    CUDA tensors go to kernel #2 of ``csrc/sweep_kernels.cuh``, at the
    geometry of :func:`sweep_rays` (launched on the
    current stream, not synchronised; ``sweep_rays_scheduled.launches``
    counts the launches, ``sweep_rays_scheduled.gated_launches`` the gated
    ones, ``sweep_rays_scheduled.geometries`` each geometry's); CPU tensors
    go to :func:`sweep_rays_scheduled_reference`. Traced as
    :func:`sweep_rays`.
    """
    device, n, n_tri_pad, tile = _check_common(
        rays, tri_pack, want_matrix, want_any, tri_tile, "sweep_rays_scheduled",
        masks=masks, emap=emap,
    )
    if masks.dim() != 2 or emap.dim() != 1:
        raise ValueError("masks must be (E, Tpad) and emap (N / 256,)")
    n_emit = int(masks.shape[0])
    _check("masks", masks, torch.float32, (n_emit, n_tri_pad), device)
    if n % RAY_SUBBLOCK:
        raise ValueError(f"sweep_rays_scheduled takes a multiple of {RAY_SUBBLOCK} rays")
    _check("emap", emap, torch.int32, (n // RAY_SUBBLOCK,), device)
    gate = _gate_for(accel, rays, n_tri_pad, tile, tri_tile, device)
    with _tracing.span("raystrack.ops.sweep"):
        geo = _launch_geometry(n, gate is not None, device)
        _check_visits(visits, n, device, geo, timeline, gate is not None)
        _count_launch(n, geo, n_tri_pad // tile)
        tiles_on = _gated_tiles_on(
            scheduled_tiles_on(masks, tile, want_matrix=want_matrix, want_any=want_any), gate)

        if device.type == "cpu":
            return sweep_rays_scheduled_reference(
                rays, tri_pack, masks, emap, tiles_on, tile,
                want_matrix=want_matrix, want_any=want_any, gate=gate, visits=visits,
                split=geo,
            )

        from .build import load_library

        lib = load_library()
        codes = torch.empty((n,), dtype=torch.int32, device=device)
        any_hit = torch.empty((n,), dtype=torch.int32, device=device)
        if n == 0:  # nothing to launch
            return codes, any_hit
        debug, fold, _held = _debug_args(visits, timeline, n, geo, int(tiles_on.shape[1]),
                                         device)
        shape, _parts = _gate_args(gate, geo, n, device)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = lib.raystrack_sweep_rays_scheduled(
                rays.data_ptr(), n, tri_pack.data_ptr(), n_tri_pad,
                masks.data_ptr(), n_emit, emap.data_ptr(), tiles_on.data_ptr(),
                int(tiles_on.shape[1]), tile, int(want_matrix), int(want_any),
                *shape, codes.data_ptr(), any_hit.data_ptr(), *debug, stream,
            )
        if err != 0:
            raise RuntimeError(f"scheduled sweep kernel launch failed: CUDA error {err}")
        fold()
        sweep_rays_scheduled.launches += 1
        sweep_rays_scheduled.gated_launches += gate is not None
        sweep_rays_scheduled.geometries[geo.name] += 1
        return codes, any_hit


sweep_rays_scheduled.launches = 0
sweep_rays_scheduled.gated_launches = 0
sweep_rays_scheduled.geometries = collections.Counter()  # launches by geometry name

__all__ = [
    "GateTables", "SweepGeometry", "build_tri_pack", "gate_cross", "gate_cross_reference",
    "gate_group_size", "gate_prunes", "sweep_rays", "sweep_split",
    "sweep_rays_reference", "sweep_rays_scheduled", "sweep_rays_scheduled_reference",
    "scheduled_tiles_on", "sweep_tile_width", "RAY_SUBBLOCK", "TRI_ROWS",
]
