"""The port's tracing (``raystrack_tpu_torch/tracing.py``) on the CPU.

Under ``torch.profiler`` a solve records its spans, nested as the module
says, each a host ``cpu_op`` and none a user annotation; the work counters
equal what the plain sweeps' ``visits=`` and the drivers' plans give; with
no profiler no counter moves and no span is made; and every solve's dicts
are ``==`` with tracing on and off, on both routes.

    JAX_PLATFORMS=cpu python -m pytest tests/test_torch_tracing.py -q
"""
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

import raystrack_tpu_torch as rt
import raystrack_tpu_torch.ops.trace as ttrace
import raystrack_tpu_torch.ops.trace_cuda as tcuda
import raystrack_tpu_torch.solver as solver_mod
from raystrack_tpu_torch import config, tracing
from raystrack_tpu_torch.ops.trace_cuda import sweep_rays, sweep_rays_scheduled
from raystrack_tpu_torch.solver import _cp_rows

CPU = torch.device("cpu")
TILE = 512  # sweep tile of these scenes: three tiles, so the gate runs


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: beside other test workers, more threads only
    contend for the same cores."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n_threads)


@pytest.fixture(autouse=True)
def _small_tiles(monkeypatch):
    monkeypatch.setattr(ttrace, "PALLAS_TRI_TILE", TILE)
    monkeypatch.setattr(solver_mod, "_log", lambda line: None)


def _street(n_tri=900, seed=0, hx=24.0, hy=1.0, top=1.6):
    """A street of random triangles closed by walls and a roof, with an
    emitter strip on its floor and a second plate above it: blocks of rays
    along the street reach few of its tiles."""
    rng = np.random.default_rng(seed)
    centers = rng.uniform([-hx, -hy, 0.2], [hx, hy, top - 0.1], size=(n_tri, 3))
    spans = rng.normal(scale=0.3, size=(n_tri, 2, 3))
    tris = [np.concatenate([centers, centers + spans[:, 0], centers + spans[:, 1]], axis=1)]
    for x in np.arange(-hx, hx):
        for a, b, c, d in (
            ([x, -hy, top], [x, hy, top], [x + 1, hy, top], [x + 1, -hy, top]),
            ([x, -hy, 0], [x + 1, -hy, 0], [x + 1, -hy, top], [x, -hy, top]),
            ([x, hy, 0], [x, hy, top], [x + 1, hy, top], [x + 1, hy, 0]),
        ):
            tris += [np.array([a + b + c]), np.array([a + c + d])]
    Vc = np.concatenate(tris).reshape(-1, 3).astype(np.float32)
    Fc = np.arange(Vc.shape[0], dtype=np.int32).reshape(-1, 3)
    quad = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    floor = np.array([[-hx, 0.1, 0], [hx, 0.1, 0], [hx, 0.3, 0], [-hx, 0.3, 0]], np.float32)
    plate = np.array([[-hx, -0.3, 0.1], [-hx, -0.1, 0.1], [hx, -0.1, 0.1], [hx, -0.3, 0.1]],
                     np.float32)
    return [("floor", floor, quad), ("plate", plate, quad), ("cloud", Vc, Fc)]


MESHES = _street()
BASE = dict(samples=2, rays=8, seed=4, device="cpu", bvh="builtin", tol=1e-3)
KINDS = ("matrix", "sky", "workflow")
ROUTES = ("grouped", "scheduled")


def _solve(kind):
    matrix = rt.MatrixParams(**BASE, max_iters=3, min_iters=2, reciprocity=True)
    sky = rt.SkyParams(**BASE, max_iters=3, min_iters=2)
    if kind == "matrix":
        return rt.view_factor_matrix(MESHES, matrix)
    if kind == "sky":
        return rt.view_factor_to_tregenza_sky(MESHES, sky)
    return rt.view_factor_outside_workflow(MESHES, matrix_params=matrix, sky_params=sky)


def _profiled(fn):
    """fn() under a CPU profiler: (its result, the profile, the counters'
    change over it)."""
    before = tracing.counts()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    return out, prof, tracing.since(before)


_SOLVES = {}


def _solved(route, kind):
    """(dict untraced, dict traced, profile, counters' change) of one solve,
    once a session per (route, kind)."""
    key = (route, kind)
    if key not in _SOLVES:
        saved = config.SCHEDULER
        config.SCHEDULER = route
        try:
            plain = _solve(kind)
            traced, prof, moved = _profiled(lambda: _solve(kind))
        finally:
            config.SCHEDULER = saved
        _SOLVES[key] = (plain, traced, prof, moved)
    return _SOLVES[key]


def _spans(prof):
    return [e for e in prof.events() if e.name.startswith("raystrack.")]


def _parent_span(event):
    """The nearest enclosing raystrack span's name, or None."""
    p = event.cpu_parent
    while p is not None and not p.name.startswith("raystrack."):
        p = p.cpu_parent
    return None if p is None else p.name


DRIVER = {
    "grouped": ("raystrack.chunk.dispatch", "raystrack.chunk.wait", "raystrack.chunk.consume"),
    "scheduled": ("raystrack.round.setup", "raystrack.round.build", "raystrack.round.wait",
                  "raystrack.round.consume"),
}
OPS = ("raystrack.ops.raygen", "raystrack.ops.masks", "raystrack.ops.gate",
       "raystrack.ops.sweep", "raystrack.ops.count")


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("route", ROUTES)
def test_solve_records_its_spans_nested(route, kind):
    """Every span of the route is there, under the solve's public span: the
    solve's set-up, rows and driver spans right under it, the ops under a
    chunk's dispatch or a round's build."""
    _, _, prof, _ = _solved(route, kind)
    spans = _spans(prof)
    public = f"raystrack.solve.{kind}"
    names = {e.name for e in spans}
    assert names == {public, "raystrack.solve.entries", "raystrack.solve.rows",
                     *DRIVER[route], *OPS}
    dispatch = "raystrack.chunk.dispatch" if route == "grouped" else "raystrack.round.build"
    for e in spans:
        parent = _parent_span(e)
        if e.name == public:
            assert parent is None
        elif e.name in OPS:
            assert parent == dispatch, (e.name, parent)
        else:
            assert parent == public, (e.name, parent)
    assert sum(e.name == public for e in spans) == 1


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("route", ROUTES)
def test_solve_dicts_equal_with_tracing_on_and_off(route, kind):
    plain, traced, _, _ = _solved(route, kind)
    assert traced == plain
    assert any(row for row in (plain if kind != "workflow" else plain[0]).values())


@pytest.mark.parametrize("route", ROUTES)
def test_no_span_is_a_user_annotation(route):
    """The spans are host cpu_ops (no device-side shadow): none is a user
    annotation, in the profile's events and in its kineto events."""
    _, _, prof, _ = _solved(route, "workflow")
    spans = _spans(prof)
    assert spans and not any(e.is_user_annotation for e in spans)
    kineto = [ev for ev in prof.profiler.kineto_results.events()
              if ev.name().startswith("raystrack.")]
    assert len(kineto) == len(spans)
    assert all(ev.device_type() == torch.autograd.DeviceType.CPU for ev in kineto)


@pytest.mark.parametrize("route", ROUTES)
def test_solve_counts_rays_from_the_plan(route, monkeypatch):
    """rays_real and rays_padded of a traced matrix solve: each chunk's
    iterations times the emitter's real and padded rays an iteration, or
    each round's schedule rows (256 rays each) and their real rays."""
    monkeypatch.setattr(config, "SCHEDULER", route)
    real, padded = [], []
    dispatch = solver_mod._EmitterRun.dispatch_chunk
    scheduled = ttrace.scheduled_trace

    def chunk(self, n, **kw):
        real.append(n * self.em_pack.n_rays_once)
        padded.append(n * self.em_pack.n_rays_pad)
        return dispatch(self, n, **kw)

    def round_(*args, **kw):
        once, schedule, block = args[8], args[10], kw["sched_block"]
        rows = (once[schedule[:, 0].long()] - schedule[:, 3]).clamp(0, block)
        real.append(int(rows.sum()))
        padded.append(schedule.shape[0] * block)
        return scheduled(*args, **kw)

    monkeypatch.setattr(solver_mod._EmitterRun, "dispatch_chunk", chunk)
    monkeypatch.setattr(ttrace, "scheduled_trace", round_)
    _, _, moved = _profiled(lambda: _solve("matrix"))
    assert real and moved["rays_real"] == sum(real)
    assert moved["rays_padded"] == sum(padded) > moved["rays_real"]


def _chunk_rays(n, meshes=MESHES):
    """The first ``n`` coherence-sorted rays of two iterations of the floor,
    the floor's operands (sky- and matrix-eligible masks, baked pack) and
    the scene pack."""
    ps = rt.PreparedSolver(meshes)
    sc = ps.get_scene_pack(use_accel=True, device=CPU)
    em = ps.get_emitter_pack(0, samples=2, rays=24, flip_faces=False, device=CPU)
    scene = (sc.v0, sc.e1, sc.e2, sc.cross_e, sc.w_u, sc.w_v, sc.d0, sc.sid)
    ext = torch.tensor([0, 1, 1, 0], dtype=torch.int32)
    pack, mask = ttrace.emitter_operands(scene, ext, 0, 1, em.plane_vec)
    tables = (em.u_cell, em.v_cell, em.h_tri, em.h_u, em.h_v, em.h_r1, em.h_r2)
    geom = (em.cdf, em.tri_a, em.tri_e1, em.tri_e2, em.tri_u, em.tri_v, em.tri_n, em.tri_eps)
    o, d = ttrace.generate_rays(tables, geom, torch.from_numpy(_cp_rows(5, 0, 0, 2)))
    valid = torch.ones(o.shape[:2], dtype=torch.bool)
    o, d, _ = ttrace._sorted_for_gate(o, d, valid, sc.accel)
    rays = ttrace.ray_pack(o, d)[:, :n].contiguous()
    return rays, pack, mask, sc


def _expected(visits, n, geo, n_tri_pad):
    """The counters one launch adds, from its per-unit visits."""
    tile = tcuda.sweep_tile_width(n_tri_pad, TILE)
    cta = torch.arange(visits.shape[0]) // geo.segments
    held = (n - cta * geo.rays).clamp(max=geo.rays)
    return dict(rays_padded=n, tiles_offered=-(-n // geo.rays) * (n_tri_pad // tile),
                tiles_swept=int(visits.sum()),
                pairs_tested=int((visits.long() * held).sum()) * tile)


@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
@pytest.mark.parametrize("n", [1000, 2048])
def test_kernel1_counts_equal_its_visits(gated, n):
    """Kernel #1's plain version under the profiler: the counters equal its
    per-CTA visits (a partial last CTA holds fewer rays); ungated, every
    CTA sweeps every active tile once across its segments, so the pairs are
    the rays times the active tiles' triangles."""
    rays, pack, mask, sc = _chunk_rays(n)
    accel = sc.accel if gated else None
    geo = tcuda._launch_geometry(n, gated, CPU)
    visits = torch.zeros(geo.units(n), dtype=torch.int32)
    kw = dict(tri_tile=TILE, want_matrix=True, want_any=True, masks_baked=True, accel=accel)
    (codes, flags), _, moved = _profiled(lambda: sweep_rays(rays, pack, mask, visits=visits,
                                                            **kw))
    want = _expected(visits, n, geo, pack.shape[1])
    assert {k: moved[k] for k in want} == want
    assert moved["rays_real"] == 0
    tile = tcuda.sweep_tile_width(pack.shape[1], TILE)
    active = int(mask.view(-1, tile).any(dim=1).sum())
    if gated:
        assert 0 < moved["tiles_swept"] <= moved["tiles_offered"]
    else:
        assert moved["pairs_tested"] == n * active * tile
    plain = sweep_rays(rays, pack, mask, **kw)
    assert torch.equal(codes, plain[0]) and torch.equal(flags, plain[1])


@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
def test_kernel2_counts_equal_its_visits(gated):
    """Kernel #2's plain version likewise, with a block whose emitter row
    lies outside the masks (it sweeps nothing)."""
    n = 1536
    rays, pack, _, sc = _chunk_rays(n)
    sid = sc.sid.numpy()
    masks = torch.from_numpy(np.stack([
        np.where(sid == 2, 2, 0), np.where(sid == 1, 1, np.where(sid == 2, 2, 0)),
    ]).astype(np.float32))
    emap = torch.tensor([0, 1, 1, 0, 5, 1], dtype=torch.int32)
    geo = tcuda._launch_geometry(n, gated, CPU)
    visits = torch.zeros(geo.units(n), dtype=torch.int32)
    _, _, moved = _profiled(lambda: sweep_rays_scheduled(
        rays, pack, masks, emap, tri_tile=TILE, want_matrix=True, want_any=False,
        accel=sc.accel if gated else None, visits=visits))
    want = _expected(visits, n, geo, pack.shape[1])
    assert {k: moved[k] for k in want} == want
    assert int(visits.view(6, -1)[4].sum()) == 0 and moved["tiles_swept"] > 0


def _listed(gate, n, geo):
    """``boxes_listed`` of a gated launch of ``n`` rays at ``geo``: each
    CTA (one segment) lists its block's boxes."""
    units = torch.arange(geo.units(n))
    return int(gate.counts.long()[units // geo.per_block].sum())


@pytest.mark.parametrize("window", [16, 0], ids=["windows", "no_window"])
@pytest.mark.parametrize("kernel", ["kernel1", "kernel2"])
def test_per_tile_gate_walk_counts(monkeypatch, kernel, window):
    """The plain gated sweeps' ``boxes_listed`` and ``boxes_walked`` on the
    per-tile gate (128 tiles of 128, early-exit windows of 16): each CTA
    lists its block's boxes and walks them until a window finds its rays
    settled, so walked <= listed, with fewer walked here where windows are
    checked and every listed box walked where none is; each swept tile lies
    under a walked box. Ungated, neither moves."""
    monkeypatch.setattr(ttrace, "PALLAS_TRI_TILE", 128)
    monkeypatch.setattr(config, "GATE_WINDOW", window)
    n = 2000 if kernel == "kernel1" else 1536
    rays, pack, mask, sc = _chunk_rays(n, _street(n_tri=16000))
    tile = tcuda.sweep_tile_width(pack.shape[1], 128)
    assert pack.shape[1] // tile == 128
    if kernel == "kernel1":
        def launch(accel):
            return sweep_rays(rays, pack, mask, tri_tile=128, want_matrix=True, want_any=True,
                              masks_baked=True, accel=accel)
    else:
        masks = torch.from_numpy(np.where(sc.sid.numpy() == 2, 2, 0).astype(np.float32))[None]
        emap = torch.tensor([0, 0, 0, 5, 0, 0], dtype=torch.int32)

        def launch(accel):
            return sweep_rays_scheduled(rays, pack, masks.expand(1, -1).contiguous(), emap,
                                        tri_tile=128, want_matrix=True, want_any=False,
                                        accel=accel)
    _, _, moved = _profiled(lambda: launch(None))
    assert moved["boxes_listed"] == moved["boxes_walked"] == 0 and moved["tiles_swept"] > 0
    _, _, moved = _profiled(lambda: launch(sc.accel))
    gate = tcuda._gate_for(sc.accel, rays, pack.shape[1], tile, 128, CPU)
    assert gate.group == 1 and gate.window == window
    geo = tcuda._launch_geometry(n, True, CPU)
    listed = _listed(gate, n, geo)
    if kernel == "kernel2":  # block 3 names no emitter row: its CTAs walk nothing
        listed -= geo.per_block * int(gate.counts[3])
    assert moved["boxes_listed"] == listed > 0
    assert moved["tiles_swept"] <= moved["boxes_walked"]
    if window:
        assert 0 < moved["boxes_walked"] < moved["boxes_listed"]
    else:
        assert moved["boxes_walked"] == moved["boxes_listed"]


def test_off_moves_no_counter_and_makes_no_span(monkeypatch):
    """With no profiler recording a solve moves no counter of tracing's own
    and never builds a span; under one it does both."""
    made = []

    class Spy:
        def __init__(self, name):
            made.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return None

    monkeypatch.setattr(tracing, "_Span", Spy)
    monkeypatch.setattr(config, "SCHEDULER", "scheduled")
    assert not tracing.on()
    before = tracing.counts()
    _solve("workflow")
    moved = tracing.since(before)
    assert all(moved[k] == 0 for k in tracing.COUNTERS)
    assert made == []
    _, _, moved = _profiled(lambda: _solve("workflow"))
    assert "raystrack.solve.workflow" in made and moved["pairs_tested"] > 0


def test_counts_hold_every_launch_counter():
    """counts() reads the launch counters where they live."""
    got = tracing.counts()
    assert got["sweep_rays.launches"] == tcuda.sweep_rays.launches
    assert got["sweep_rays_scheduled.gated_launches"] == tcuda.sweep_rays_scheduled.gated_launches
    assert got["gate_cross.launches"] == tcuda.gate_cross.launches
    assert {"count_bins.launches", "fma_peak.launches", "mask_rows.launches",
            "sweep_rays.code_launches", *tracing.COUNTERS} <= set(got)
