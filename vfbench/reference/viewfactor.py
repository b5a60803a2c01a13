"""A plain reference of the view-factor solves the benchmark times.

It implements, from the upstream raystrack semantics and independently of
the program, the three public solves of a scene of named triangle meshes
``(name, V float32 (n, 3), F int32 (m, 3))``:

- the matrix F(i -> j) split by the side of j hit (``<name>_front`` where
  the ray meets the side the winding faces, ``_back`` otherwise), with
  reciprocity (emitter i traces only receivers j > i, the lower surfaces
  are not eligible, and F(j -> i)_front = F(i -> j)_front A_i / A_j);
- the sky: the rays that hit no eligible triangle, upward (``Sky``) or per
  Tregenza patch (``Sky_Patch_1`` .. ``Sky_Patch_145``);
- the outside workflow: both on shared rays, the sky clamped so that scene +
  sky <= 1 + 1e-6, pairwise reciprocity, and ``Rest`` = 1 - scene - sky.

The sampling is the upstream's definition, with its tables in float32:
a g x g stratified Halton grid per emitter (g = max(4, ceil(sqrt(area *
samples)))), ``rays`` rays a cell, five Halton dimensions (bases 5, 2, 3,
7, 11) a ray, and per iteration seven Cranley-Patterson offsets drawn from
``numpy.random.default_rng(seed + emitter + iteration)``. The offset sums
wrap in float32, as the tables are defined; the triangle is picked from the
float32 area CDF. The rest, the point on the triangle, the cosine-weighted
direction, the origin's offset, and the ray-triangle test, runs in
``dtype``: float64 for the reference, a lower precision for the control.
A ray hits a triangle when |det| >= 1e-7, its barycentric coordinates lie
in the closed triangle and t > 1e-6; the nearest hit wins, the smaller
code (2 * surface + front) on a tie. Convergence is the upstream's:
Welford replicates of each iteration's fractions, checked every
``convergence_interval`` iterations from ``min_iters`` on.

The nearest hit is exact but for rounding. Up to ``BRUTE_MAX_TRIS``
triangles every ray meets every triangle; past it a uniform grid over the
triangles' xy bounds gives each ray the triangles whose bounds meet its
segment from the origin to ``t`` in growing shells, and a ray with no hit
inside the last shell meets every triangle. This file imports nothing of
the program it judges.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import numpy as np
import torch

TWO_PI = 6.283185307179586
HALTON_BASES = (5, 2, 3, 7, 11)
INF = float("inf")
BRUTE_MAX_TRIS = 4096
SHELLS = (0.25, 2.0, 16.0)  # segment lengths of the grid's passes, m
MAX_CELLS = 64  # grid cells a ray's segment may span before it goes brute force
PAIRS = 1 << 23  # ray-triangle pairs a step
RAYS_A_CHUNK = 1 << 22  # rays generated a step

# Tregenza: sin of each ring's upper altitude edge, patches a ring, first id
RING_HI_SIN = (0.20791169081775934, 0.40673664307580015, 0.5877852522924731,
               0.7431448254773942, 0.8660254037844386, 0.9510565162951535,
               0.9945218953682733)
RING_N = (30, 30, 24, 24, 18, 12, 6, 1)
RING_START = (0, 30, 60, 84, 108, 126, 138, 144)
N_PATCHES = 145


# ---------------------------------------------------------------------------
# sampling tables
# ---------------------------------------------------------------------------

def radical_inverse(indices: np.ndarray, base: int) -> np.ndarray:
    """Van der Corput radical inverse of non-negative integers, float64:
    the digit-reversed integer over base**K, K the digits of the largest."""
    idx = np.asarray(indices, dtype=np.int64)
    if idx.size == 0:
        return np.zeros(0)
    k, top = 1, base
    while top <= int(idx.max()):
        k, top = k + 1, top * base
    rev, rem = np.zeros_like(idx), idx.copy()
    for _ in range(k):
        rev, rem = rev * base + rem % base, rem // base
    return rev / float(base ** k)


def halton_grid(g: int) -> Tuple[np.ndarray, np.ndarray]:
    """Cell c of the g x g grid: u = (h2(c + 1) + c // g) / g, v = (h3(c + 1)
    + c % g) / g, float32."""
    c = np.arange(g * g, dtype=np.int64)
    u = (radical_inverse(c + 1, 2) + (c // g)) / g
    v = (radical_inverse(c + 1, 3) + (c % g)) / g
    return u.astype(np.float32), v.astype(np.float32)


def halton_dims(n: int) -> Tuple[np.ndarray, ...]:
    """Ray r's five dimensions: Halton index r + 1 in bases 5, 2, 3, 7, 11."""
    idx = np.arange(1, n + 1, dtype=np.int64)
    return tuple(radical_inverse(idx, b).astype(np.float32) for b in HALTON_BASES)


def cp_offsets(seed: int, emitter: int, iteration: int) -> np.ndarray:
    """Iteration's seven Cranley-Patterson offsets: two for the grid, then
    triangle, barycentric u and v, and the hemisphere's two."""
    rng = np.random.default_rng(seed + emitter + iteration)
    out = np.empty(7, np.float32)
    out[:2] = rng.random(2, dtype=np.float32)
    out[2:] = rng.random(5, dtype=np.float32)
    return out


@dataclass
class Emitter:
    a: np.ndarray  # (F, 3) float32 first vertex of each triangle
    e1: np.ndarray  # (F, 3) float32 edges, as wound (flipped if asked)
    e2: np.ndarray
    cdf: np.ndarray  # (F,) float32 area CDF
    area: float
    g: int
    rays: int

    @property
    def n_rays(self) -> int:
        return self.g * self.g * self.rays


def emitter(V: np.ndarray, F: np.ndarray, samples: float, rays: int,
            flip: bool = False) -> Emitter:
    F = F[:, [0, 2, 1]] if flip else F
    a = np.asarray(V[F[:, 0]], np.float32)
    e1 = np.asarray(V[F[:, 1]], np.float32) - a
    e2 = np.asarray(V[F[:, 2]], np.float32) - a
    tri_area = 0.5 * np.linalg.norm(np.cross(e1, e2), axis=1)  # float32
    area = float(tri_area.sum())
    if area <= 0.0:
        raise ValueError("a zero-area emitter")
    cum = np.cumsum(tri_area, dtype=np.float64)
    g = max(4, int(math.ceil(math.sqrt(max(area, 0.0) * samples))))
    return Emitter(a, e1, e2, (cum / cum[-1]).astype(np.float32), area, g, int(rays))


def _frames(n: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tangent frame (u, v) of unit normals: u from the world x axis unless
    |n_x| >= 0.9 (then y), v = n x u."""
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=n.dtype, device=n.device).expand_as(n)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=n.dtype, device=n.device).expand_as(n)
    ref = torch.where((n[:, 0].abs() < 0.9)[:, None], ex, ey)
    u = torch.linalg.cross(ref, n)
    u = u / u.norm(dim=1, keepdim=True)
    return u, torch.linalg.cross(n, u)


class EmitterRays:
    """Ray generator of one emitter on ``device`` in ``dtype``."""

    def __init__(self, em: Emitter, device, dtype):
        self.em, self.device, self.dtype = em, device, dtype
        self.addr = torch.float32 if dtype == torch.float64 else dtype
        put = lambda a, t: torch.as_tensor(a).to(device=device, dtype=t)  # noqa: E731
        u_grid, v_grid = halton_grid(em.g)
        cell = np.arange(em.n_rays) // em.rays
        self.tables = [put(u_grid[cell], self.addr), put(v_grid[cell], self.addr)] + [
            put(t, self.addr) for t in halton_dims(em.n_rays)]
        self.cdf = put(em.cdf, self.addr)
        a64, e1_64, e2_64 = (x.astype(np.float64) for x in (em.a, em.e1, em.e2))
        n = np.cross(e1_64, e2_64)
        n /= np.maximum(np.linalg.norm(n, axis=1, keepdims=True), 1e-300)
        edges = np.stack([np.linalg.norm(e1_64, axis=1), np.linalg.norm(e2_64, axis=1),
                          np.linalg.norm(e2_64 - e1_64, axis=1)])
        eps = np.maximum(edges.max(axis=0) * 1e-6, 1e-8)
        n_t = put(n, torch.float64)
        u, v = _frames(n_t)
        self.geom = [put(x, dtype) for x in (a64, e1_64, e2_64)] + [
            t.to(dtype) for t in (u, v, n_t)] + [put(eps, dtype)]

    def generate(self, cps: np.ndarray):
        """Origins and directions (k * n_rays, 3) for the k iterations whose
        offsets are the rows of ``cps``."""
        off = torch.as_tensor(cps).to(device=self.device, dtype=self.addr)
        col = lambda k: off[:, k:k + 1]  # noqa: E731
        u_cell, v_cell, h_tri, h_u, h_v, h_r1, h_r2 = (t[None, :] for t in self.tables)
        ug = torch.remainder(u_cell + col(0), 1.0)
        vg = torch.remainder(v_cell + col(1), 1.0)
        q = torch.remainder(h_tri + col(2), 1.0)
        tri = torch.searchsorted(self.cdf, q.contiguous()).clamp_(0, self.cdf.shape[0] - 1)
        ur = torch.remainder(h_u + col(3) + ug, 1.0).to(self.dtype)
        vr = torch.remainder(h_v + col(4) + vg, 1.0).to(self.dtype)
        r1 = torch.remainder(h_r1 + col(5), 1.0).to(self.dtype)
        r2 = torch.remainder(h_r2 + col(6), 1.0).to(self.dtype)
        a, e1, e2, fu, fv, fn, eps = (g[tri] for g in self.geom)
        s = torch.sqrt(ur)
        point = a + (s * vr)[..., None] * e1 + (s * (1.0 - vr))[..., None] * e2
        sin_t = torch.sqrt(1.0 - r1)
        phi = TWO_PI * r2
        d = ((sin_t * torch.cos(phi))[..., None] * fu + (sin_t * torch.sin(phi))[..., None] * fv
             + torch.sqrt(r1)[..., None] * fn)
        o = point + eps[..., None] * fn
        return o.reshape(-1, 3), d.reshape(-1, 3)


def tregenza_patch(d: torch.Tensor) -> torch.Tensor:
    """Tregenza patch id 0..144 of each direction, -1 where d_z <= 0: the ring
    is the count of ring edges at or below d_z, odd rings turned by half a
    patch."""
    dx, dy, dz = d.double().unbind(1)
    hi = torch.tensor(RING_HI_SIN, dtype=torch.float64, device=d.device)
    ring = (dz[:, None] >= hi).sum(dim=1)
    n_az = torch.tensor(RING_N, device=d.device)[ring]
    start = torch.tensor(RING_START, device=d.device)[ring]
    az = torch.rad2deg(torch.atan2(dy, dx)) % 360.0
    width = 360.0 / n_az
    turn = torch.where(ring % 2 == 1, width / 2.0, 0.0)
    az = (az - turn) % 360.0
    col = torch.minimum((az / width).long(), n_az - 1)
    pid = torch.where(n_az == 1, start, start + col)
    return torch.where(dz > 0.0, pid, -1)


# ---------------------------------------------------------------------------
# the scene and the nearest hit
# ---------------------------------------------------------------------------

def _pair_hits(o, d, v0, e1, e2):
    """(t, hit, front) of rays against triangles (broadcast over leading
    dims): Moeller-Trumbore with the closed triangle, |det| >= 1e-7,
    t > 1e-6; ``front`` (det > 0) where the ray meets the wound side."""
    p = torch.linalg.cross(d, e2)
    det = (e1 * p).sum(-1)
    tv = o - v0
    u = (tv * p).sum(-1)
    q = torch.linalg.cross(tv, e1)
    v = (d * q).sum(-1)
    t = (e2 * q).sum(-1) / det
    sign = torch.where(det >= 0.0, 1.0, -1.0).to(det.dtype)
    ad, un, vn = det * sign, u * sign, v * sign
    hit = (ad >= 1e-7) & (un >= 0.0) & (vn >= 0.0) & (un + vn <= ad) & (t > 1e-6)
    return t, hit, det > 0.0


class Scene:
    """Every mesh's triangles on ``device`` in ``dtype``, with their surface
    ids, and past ``BRUTE_MAX_TRIS`` triangles the xy grid."""

    def __init__(self, meshes, device, dtype):
        self.device, self.dtype = device, dtype
        v0, e1, e2, sid = [], [], [], []
        for s, (_, V, F) in enumerate(meshes):
            a = np.asarray(V[F[:, 0]], np.float32)
            v0.append(a)
            e1.append(np.asarray(V[F[:, 1]], np.float32) - a)
            e2.append(np.asarray(V[F[:, 2]], np.float32) - a)
            sid.append(np.full(F.shape[0], s, np.int64))
        put = lambda xs, t: torch.as_tensor(np.concatenate(xs)).to(device=device, dtype=t)  # noqa: E731
        self.v0, self.e1, self.e2 = put(v0, dtype), put(e1, dtype), put(e2, dtype)
        self.sid = put(sid, torch.int64)
        self.n = self.sid.shape[0]
        self.grid = _Grid(put(v0, torch.float64), put(e1, torch.float64),
                          put(e2, torch.float64)) if self.n > BRUTE_MAX_TRIS else None

    def trace(self, o, d, emit: int, min_sid: int, *, nearest: bool, any_hit: bool):
        """Per ray: the nearest hit's code among triangles of surfaces >=
        ``min_sid`` but ``emit`` (-1 for none), and whether any triangle but
        ``emit``'s is hit."""
        n = o.shape[0]
        best_t = torch.full((n,), INF, dtype=torch.float64, device=self.device)
        best_code = torch.full((n,), -1, dtype=torch.int64, device=self.device)
        hit_any = torch.zeros(n, dtype=torch.bool, device=self.device)
        rule = (emit, min_sid, nearest, any_hit)
        carries = (best_t, best_code, hit_any)
        if self.grid is None:
            self._brute(o, d, torch.arange(n, device=self.device), carries, rule)
        else:
            self.grid.trace(self, o, d, carries, rule)
        return best_code, hit_any

    def _fold(self, ray, t, hit, front, sid, best_t, best_code, hit_any, rule, t_max=INF):
        """Fold the tests of pairs (ray[k], triangle of surface sid[k]) at
        t <= t_max into the per-ray carries: the smallest t, the smallest
        code among equal t, and whether any eligible triangle is hit."""
        emit, min_sid, nearest, any_hit = rule
        t = t.double()
        hit = hit & (sid != emit) & (t <= t_max)
        if any_hit:
            hit_any.index_fill_(0, ray[hit], True)
        if not nearest:
            return
        hit &= sid >= min_sid
        t_m = torch.where(hit, t, INF)
        step_t = torch.full_like(best_t, INF).scatter_reduce_(0, ray, t_m, "amin")
        code = 2 * sid + front.long()
        at_min = hit & (t_m == step_t[ray])
        step_code = torch.full_like(best_code, 1 << 40).scatter_reduce_(
            0, ray[at_min], code[at_min], "amin")
        tie = (step_t == best_t) & (step_t < INF)
        best_code.copy_(torch.where(step_t < best_t, step_code,
                                    torch.where(tie, torch.minimum(best_code, step_code),
                                                best_code)))
        best_t.copy_(torch.minimum(best_t, step_t))

    def _pairs(self, ray, tri, o, d, carries, rule, t_max=INF):
        t, hit, front = _pair_hits(o[ray], d[ray], self.v0[tri], self.e1[tri], self.e2[tri])
        self._fold(ray, t, hit, front, self.sid[tri], *carries, rule, t_max)

    def _brute(self, o, d, rays, carries, rule):
        """Every ray of ``rays`` against every triangle, about PAIRS pairs a
        step: rays broadcast against a block of triangles."""
        for t0 in range(0, self.n, PAIRS):
            t1 = min(self.n, t0 + PAIRS)
            v0, e1, e2 = (x[None, t0:t1] for x in (self.v0, self.e1, self.e2))
            step = max(1, PAIRS // (t1 - t0))
            for r0 in range(0, rays.numel(), step):
                rs = rays[r0:r0 + step]
                t, hit, front = _pair_hits(o[rs][:, None], d[rs][:, None], v0, e1, e2)
                ray = rs[:, None].expand(-1, t1 - t0)
                sid = self.sid[None, t0:t1].expand_as(ray)
                self._fold(ray.reshape(-1), t.reshape(-1), hit.reshape(-1),
                           front.reshape(-1), sid.reshape(-1), *carries, rule)


class _Grid:
    """Triangles binned into every cell of a uniform xy grid that their xy
    bounds meet (bounds widened by a margin, so rounding cannot drop one)."""

    def __init__(self, v0, e1, e2):
        lo = torch.minimum(torch.minimum(v0, v0 + e1), v0 + e2)[:, :2]
        hi = torch.maximum(torch.maximum(v0, v0 + e1), v0 + e2)[:, :2]
        self.margin = 1e-6 * float((hi.max() - lo.min()).abs()) + 1e-9
        lo, hi = lo - self.margin, hi + self.margin
        self.origin = lo.min(dim=0).values
        span = hi.max(dim=0).values - self.origin
        n = v0.shape[0]
        cell = float(span.prod() / max(n, 1)) ** 0.5
        while True:  # the smallest cell (by factors of 2) that keeps entries under 16 a triangle
            nx, ny = (int(x) + 1 for x in (span / cell).ceil().tolist())
            i0, i1 = self._cells(lo, cell), self._cells(hi, cell)
            counts = ((i1[:, 0] - i0[:, 0] + 1) * (i1[:, 1] - i0[:, 1] + 1))
            if int(counts.sum()) <= 16 * n or cell > float(span.max()):
                break
            cell *= 2.0
        self.cell, self.nx, self.ny = cell, nx, ny
        tri = torch.repeat_interleave(torch.arange(n, device=v0.device), counts)
        first = torch.cumsum(counts, 0) - counts
        k = torch.arange(tri.numel(), device=v0.device) - first[tri]
        wide = (i1[:, 0] - i0[:, 0] + 1)[tri]
        key = (i0[tri, 1] + k // wide) * nx + i0[tri, 0] + k % wide
        del k, wide, first
        key, order = torch.sort(key)
        self.tris = tri[order].to(torch.int32)
        del tri, order
        self.start = torch.searchsorted(key, torch.arange(nx * ny + 1, device=v0.device))

    def _cells(self, xy, cell):
        return ((xy - self.origin) / cell).floor().long()

    def trace(self, scene, o, d, carries, rule):
        """Shell by shell, each pending ray against the triangles of the
        cells its segment [0, length] meets; a ray whose nearest hit (or,
        for the any-hit, some hit) lies within the segment is done. What is
        left meets every triangle."""
        best_t, _, hit_any = carries
        _, _, nearest, any_hit = rule
        o64, d64 = o.double(), d.double()
        dev = o.device
        pending = torch.arange(o.shape[0], device=dev)
        for length in SHELLS:
            if pending.numel() == 0:
                return
            a = o64[pending, :2]
            b = a + length * d64[pending, :2]
            i0 = self._cells(torch.minimum(a, b) - self.margin, self.cell)
            i1 = self._cells(torch.maximum(a, b) + self.margin, self.cell)
            for axis, top in ((0, self.nx - 1), (1, self.ny - 1)):
                i0[:, axis].clamp_(0, top)
                i1[:, axis].clamp_(0, top)
            wide = i1[:, 0] - i0[:, 0] + 1
            n_cells = wide * (i1[:, 1] - i0[:, 1] + 1)
            fits = n_cells <= MAX_CELLS
            rays, i0, wide, n_cells = pending[fits], i0[fits], wide[fits], n_cells[fits]
            local = torch.repeat_interleave(torch.arange(rays.numel(), device=dev), n_cells)
            k = torch.arange(local.numel(), device=dev) - (torch.cumsum(n_cells, 0)
                                                          - n_cells)[local]
            key = (i0[local, 1] + k // wide[local]) * self.nx + i0[local, 0] + k % wide[local]
            self._cell_pairs(scene, rays[local], self.start[key],
                             self.start[key + 1] - self.start[key], o, d, carries, rule, length)
            done = torch.ones(o.shape[0], dtype=torch.bool, device=dev)
            if nearest:
                done &= best_t <= length
            if any_hit:
                done &= hit_any
            pending = pending[~done[pending]]
        scene._brute(o, d, pending, carries, rule)

    def _cell_pairs(self, scene, ray_of_cell, first, size, o, d, carries, rule, t_max):
        """Every (ray, triangle) pair of the (ray, cell) entries, about PAIRS
        pairs a step."""
        ends = torch.cumsum(size, 0)
        c0 = 0
        while c0 < size.numel():
            base = int(ends[c0 - 1]) if c0 else 0
            c1 = int(torch.searchsorted(ends, torch.tensor(base + PAIRS, device=ends.device),
                                        right=True))
            c1 = max(c1, c0 + 1)
            sz = size[c0:c1]
            which = torch.repeat_interleave(torch.arange(c0, c1, device=sz.device), sz)
            k = torch.arange(which.numel(), device=sz.device) - (torch.cumsum(sz, 0) - sz)[
                which - c0]
            scene._pairs(ray_of_cell[which], self.tris[first[which] + k].long(), o, d, carries,
                         rule, t_max)
            c0 = c1


# ---------------------------------------------------------------------------
# convergence
# ---------------------------------------------------------------------------

class Welford:
    def __init__(self, shape):
        self.mean = np.zeros(shape)
        self.m2 = np.zeros(shape)
        self.count = 0

    def update(self, x) -> None:
        self.count += 1
        delta = x - self.mean
        self.mean = self.mean + delta / self.count
        self.m2 = self.m2 + delta * (x - self.mean)

    def stderr(self):
        if self.count > 1:
            return np.sqrt(np.maximum(self.m2 / (self.count - 1), 0.0) / self.count)
        return np.full_like(self.mean, np.inf)


def _check_due(done: int, p: dict) -> bool:
    """Whether convergence is checked after ``done`` iterations."""
    start = max(1, int(p["min_iters"]))
    if done < start or (p["tol_mode"] == "stderr" and done <= 1):
        return False
    if done >= int(p["max_iters"]):
        return True
    span = max(1, int(p["convergence_interval"]))
    return span <= 1 or (done - start) % span == 0


class Monitor:
    """Running sums of one emitter's per-iteration counts (a vector) and its
    stopping rule: stderr of the iterations' fractions, or the change of
    the running estimate, on ``watch`` components."""

    def __init__(self, p: dict, n_rays: int, size: int, watch=None):
        self.p, self.n_rays = p, n_rays
        self.total = np.zeros(size, np.int64)
        self.w = Welford(size)
        self.watch = np.arange(size) if watch is None else np.asarray(watch, np.int64)
        self.prev = None
        self.iters = 0
        self.done = False

    def add(self, counts: np.ndarray) -> None:
        if self.done:
            return
        self.total += counts
        self.iters += 1
        self.w.update(counts.astype(np.float64) * (1.0 / float(self.n_rays)))
        if _check_due(self.iters, self.p):
            if self.p["tol_mode"] == "stderr":
                self.done = bool(np.all(self.w.stderr()[self.watch] <= self.p["tol"]))
            else:
                cur = self.total / float(self.iters * self.n_rays)
                if self.prev is not None and np.all(
                        np.abs(cur - self.prev)[self.watch] < self.p["tol"]):
                    self.done = True
                self.prev = cur
        if self.iters >= int(self.p["max_iters"]):
            self.done = True

    def fractions(self) -> np.ndarray:
        return self.total / float(self.iters * self.n_rays)


# ---------------------------------------------------------------------------
# the solves
# ---------------------------------------------------------------------------

def _areas(meshes) -> np.ndarray:
    out = []
    for _, V, F in meshes:
        V = np.asarray(V, np.float64)
        out.append(0.5 * np.linalg.norm(np.cross(V[F[:, 1]] - V[F[:, 0]],
                                                 V[F[:, 2]] - V[F[:, 0]]), axis=1).sum())
    return np.asarray(out)


def _trace_emitter(scene: Scene, rays: EmitterRays, idx: int, seed: int, min_sid: int,
                   monitors: Dict[str, Monitor], n_surf: int, discrete: bool) -> None:
    """Iterations of one emitter until each monitor is done: ``matrix``
    takes (2 * n_surf) code counts, ``sky`` the upward or per-patch misses."""
    n = rays.em.n_rays
    itr = 0
    while not all(m.done for m in monitors.values()):
        left = max(int(m.p["max_iters"]) - m.iters for m in monitors.values() if not m.done)
        k = max(1, min(left, RAYS_A_CHUNK // n))
        o, d = rays.generate(np.stack([cp_offsets(seed, idx, itr + j) for j in range(k)]))
        want_m = "matrix" in monitors and not monitors["matrix"].done
        want_s = "sky" in monitors and not monitors["sky"].done
        code, hit = scene.trace(o, d, idx, min_sid, nearest=want_m, any_hit=want_s)
        it = torch.arange(k, device=o.device).repeat_interleave(n)
        if want_m:
            bins = torch.where(code >= 0, it * 2 * n_surf + code, -1)
            counts = torch.bincount(bins[bins >= 0], minlength=k * 2 * n_surf)
            counts = counts.view(k, 2 * n_surf).cpu().numpy()
        if want_s:
            if discrete:
                pid = tregenza_patch(d)
                pid = torch.where(hit, -1, pid)
                sky = torch.bincount((it * N_PATCHES + pid)[pid >= 0],
                                     minlength=k * N_PATCHES).view(k, N_PATCHES)
            else:
                up = (~hit) & (d[:, 2] > 0.0)
                sky = torch.bincount(it[up], minlength=k).view(k, 1)
            sky = sky.cpu().numpy()
        for j in range(k):
            if want_m:
                monitors["matrix"].add(counts[j])
            if want_s:
                monitors["sky"].add(sky[j])
        itr += k


def _row(names, idx, mon: Monitor, receivers, reciprocity, areas, vf) -> None:
    f = mon.fractions()
    for j in receivers:
        front, back = f[2 * j + 1], f[2 * j]
        if front > 0.0:
            vf[names[idx]][f"{names[j]}_front"] = float(front)
            if reciprocity and areas[j] > 0.0:
                vf[names[j]][f"{names[idx]}_front"] = float(front * areas[idx] / areas[j])
        if back > 0.0:
            vf[names[idx]][f"{names[j]}_back"] = float(back)


def _sky_row(mon: Monitor, discrete: bool) -> Dict[str, float]:
    f = mon.fractions()
    if discrete:
        return {f"Sky_Patch_{i + 1}": float(f[i]) for i in range(N_PATCHES)}
    return {"Sky": float(f[0])}


def solve(meshes, *, matrix: Optional[dict] = None, sky: Optional[dict] = None,
          device="cpu", dtype=torch.float64):
    """The matrix (``matrix``: MatrixParams fields), the sky (``sky``:
    SkyParams fields), or both from shared rays: ``(vf, sky_vf)`` with None
    for the side not asked for. Shared rays need equal sampling fields."""
    p = matrix or sky
    if matrix and sky and any(matrix[k] != sky[k] for k in ("samples", "rays", "seed")):
        raise ValueError("shared rays need equal samples, rays and seed")
    if matrix and matrix.get("enforce_reciprocity_rowsum"):
        raise NotImplementedError("enforce_reciprocity_rowsum")
    names = [m[0] for m in meshes]
    n_surf = len(meshes)
    reciprocity = bool(matrix and matrix["reciprocity"])
    flip = bool(matrix and matrix["flip_faces"])
    discrete = bool(sky and sky["discrete"])
    scene = Scene(meshes, device, dtype)
    areas = _areas(meshes)
    vf = {n: {} for n in names} if matrix else None
    sky_vf = {n: {} for n in names} if sky else None
    for idx, (_, V, F) in enumerate(meshes):
        receivers = [j for j in range(n_surf) if (j > idx if reciprocity else j != idx)]
        monitors = {}
        if matrix and receivers:
            watch = [c for j in receivers for c in (2 * j, 2 * j + 1)]
            monitors["matrix"] = None, watch
        if sky:
            monitors["sky"] = None, None
        if not monitors:
            continue
        em = emitter(V, F, p["samples"], p["rays"], flip)
        for key in list(monitors):
            params = matrix if key == "matrix" else sky
            size = 2 * n_surf if key == "matrix" else (N_PATCHES if discrete else 1)
            monitors[key] = Monitor(params, em.n_rays, size, monitors[key][1])
        gen = EmitterRays(em, device, dtype)
        _trace_emitter(scene, gen, idx, int(p["seed"]), idx + 1 if reciprocity else 0,
                       monitors, n_surf, discrete)
        if "matrix" in monitors:
            _row(names, idx, monitors["matrix"], receivers, reciprocity, areas, vf)
        if sky:
            sky_vf[names[idx]] = _sky_row(monitors["sky"], discrete)
        del gen
    return vf, sky_vf


def _split(row: Dict[str, float], base: str) -> Tuple[float, float]:
    return row.get(f"{base}_front", 0.0), row.get(f"{base}_back", 0.0)


def reciprocity_average(vf, meshes, tol: float = 1e-12) -> None:
    """Pairwise reciprocity: both totals of a pair become (A_i F_ij + A_j
    F_ji) / 2 over their own area, each row's front/back split kept in
    proportion (a receiver with none gets it on the back key); pairs and
    keys at or below ``tol`` are dropped."""
    names = [m[0] for m in meshes]
    A = _areas(meshes)
    n = len(names)
    F = np.zeros((n, n))
    for i, a in enumerate(names):
        for j, b in enumerate(names):
            F[i, j] = sum(_split(vf.get(a, {}), b))
    new = F.copy()
    for i in range(n):
        for j in range(i + 1, n):
            if F[i, j] <= tol and F[j, i] <= tol:
                new[i, j] = new[j, i] = 0.0
                continue
            g = 0.5 * (A[i] * F[i, j] + A[j] * F[j, i])
            new[i, j] = max(g / A[i], 0.0) if A[i] > 0 else 0.0
            new[j, i] = max(g / A[j], 0.0) if A[j] > 0 else 0.0
    for i, a in enumerate(names):
        row = vf.setdefault(a, {})
        for j, b in enumerate(names):
            if i == j:
                continue
            fo, bo = _split(row, b)
            old = fo + bo
            f_new, b_new = (fo * new[i, j] / old, bo * new[i, j] / old) if old > 0 else (
                0.0, new[i, j])
            for key, val in ((f"{b}_front", f_new), (f"{b}_back", b_new)):
                if val > tol:
                    row[key] = val
                else:
                    row.pop(key, None)


def workflow(meshes, matrix: dict, sky: dict, *, device="cpu", dtype=torch.float64):
    """The outside workflow: ``(scene, sky, rest)``."""
    vf, sky_vf = solve(meshes, matrix={**matrix, "enforce_reciprocity_rowsum": False},
                       sky=sky, device=device, dtype=dtype)
    discrete = bool(sky["discrete"])
    names = [m[0] for m in meshes]

    def clamp(name, zero_when_full: bool) -> float:
        scene = sum(vf.get(name, {}).values())
        row = sky_vf[name]
        total = sum(row.values())
        if scene + total > 1.0 + 1e-6 and total > 0.0:
            allowed = max(0.0, 1.0 - scene)
            if zero_when_full and allowed <= 0.0:
                sky_vf[name] = {k: 0.0 for k in row}
            else:
                scale = min(1.0, allowed / total)
                sky_vf[name] = {k: v * scale for k, v in row.items()}
        return scene + sum(sky_vf[name].values())

    for name in names:
        clamp(name, False)
    if matrix["reciprocity"]:
        reciprocity_average(vf, meshes)
    rest = {}
    for name in names:
        residual = 1.0 - clamp(name, True)
        rest[name] = {"Rest": 0.0 if abs(residual) <= 1e-6 else residual}
    return vf, sky_vf, rest
