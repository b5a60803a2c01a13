"""The port's ray mesh (``raystrack_tpu_torch.parallel.sharding``) on the CPU.

A logical mesh of CPU shards (``ray_mesh([torch.device("cpu")] * n)``)
runs each shard's chunk or round with the sweeps' plain versions, as the
JAX package's tests shard over the 8 virtual CPU devices its conftest
makes. Held here:

- a sharded chunk ``==`` the single chunk (1, 2, 3 and 8 shards, gated and
  ungated, every output), and a shard of padding only counts zero;
- a sharded scheduled round ``==`` the single round (1, 3 and 8 shards,
  a row count that does not divide);
- the matrix, the sky (merged and discrete), the shared-ray workflow and
  the outside workflow ``==`` their ``mesh=None`` solves on both routes;
  a slim scene, a gated scene and a checkpointed solve resumed at another
  shard count too; a logical mesh holds one copy of each pack;
- the port's 8-shard solves within |dF| <= 1e-4 of the JAX package's
  8-device ``ray_mesh()`` solves, with the same key sets;
- a mixed mesh raises ``ValueError``, ``ray_mesh()`` without a card raises.
"""
import numpy as np
import pytest
import torch

import raystrack_tpu
from raystrack_tpu.parallel import ray_mesh as jax_ray_mesh

import raystrack_tpu_torch
import raystrack_tpu_torch.ops.trace as ttrace
import raystrack_tpu_torch.prepared as tprep
import raystrack_tpu_torch.solver as tsolver
from raystrack_tpu_torch import config as tconfig
from raystrack_tpu_torch.api import view_factor_outside_workflow
from raystrack_tpu_torch.config import RAY_BLOCK
from raystrack_tpu_torch.ops.trace_cuda import build_tri_pack, sweep_rays
from raystrack_tpu_torch.parallel import RAY_AXIS, ray_mesh, trace_chunk_sharded
from raystrack_tpu_torch.parallel.sharding import RayMesh, scheduled_trace_sharded
from raystrack_tpu_torch.solver import _build_emitter_surface_mask, _cp_rows

CPU = torch.device("cpu")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: beside other test workers, more threads only
    contend for the same cores."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n_threads)


def cpu_mesh(n: int) -> RayMesh:
    return ray_mesh([CPU] * n)


def _square(name, size, z, normal=1, center=(0.0, 0.0)):
    cx, cy = center
    h = size / 2.0
    V = np.array([[cx - h, cy - h, z], [cx + h, cy - h, z], [cx + h, cy + h, z],
                  [cx - h, cy + h, z]], dtype=np.float32)
    F = np.array([[0, 1, 2], [0, 2, 3]] if normal >= 0 else [[0, 2, 1], [0, 3, 2]],
                 dtype=np.int32)
    return name, V, F


# tests/test_sharding.py's scene
MESHES = [
    _square("ground", 2.0, 0.0, normal=+1),
    _square("mid", 1.5, 0.6, normal=-1, center=(0.4, 0.1)),
    _square("top", 3.0, 1.2, normal=-1),
]


def _street(n_tri=1100, seed=0, hx=32.0, hy=1.0, top=1.6):
    """tests/test_torch_gate.py's cluttered street: a canyon of roof and
    wall quads filled with random triangles over a 64 x 0.2 m emitter strip;
    with 128-triangle sweep tiles the gate prunes most of it."""
    V = np.array([[-hx, 0.1, 0], [hx, 0.1, 0], [hx, 0.3, 0], [-hx, 0.3, 0]], np.float32)
    F = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
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
    return [("emitter", V, F),
            ("cloud", Vc, np.arange(Vc.shape[0], dtype=np.int32).reshape(-1, 3))]


def _scene_t(sp):
    return (sp.v0, sp.e1, sp.e2, sp.cross_e, sp.w_u, sp.w_v, sp.d0, sp.sid)


def _tables(em):
    return (em.u_cell, em.v_cell, em.h_tri, em.h_u, em.h_v, em.h_r1, em.h_r2)


def _geom(em):
    return (em.cdf, em.tri_a, em.tri_e1, em.tri_e2, em.tri_u, em.tri_v, em.tri_n, em.tri_eps)


KINDS = {"matrix": (True, False, False), "sky": (False, True, False),
         "sky_discrete": (False, True, True), "matrix_sky": (True, True, False)}


@pytest.fixture(scope="module")
def street():
    """The street's prepared solver and its accel scene pack on the CPU."""
    ps = tprep.PreparedSolver(_street(seed=2))
    return ps, ps.get_scene_pack(use_accel=True, device=CPU)


def _chunk_args(ps, sp, align, want_any):
    """Emitter 0's operands and tables padded to ``align``: 2 iterations of
    480 real rays (2 samples x 24 rays over 10 x 2 cells)."""
    em = ps.get_emitter_pack(0, samples=2, rays=24, flip_faces=False, align=align, device=CPU)
    ext = torch.tensor([0, 1, 0], dtype=torch.int32)
    pack, mask = ttrace.emitter_operands(_scene_t(sp), ext, 0, 1, em.plane_vec,
                                         want_any=want_any)
    return em, (pack, mask, _tables(em), _geom(em), torch.from_numpy(_cp_rows(5, 0, 0, 2)),
                sp.n_surf, em.n_rays_once)


@pytest.mark.parametrize("kind", sorted(KINDS))
@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
@pytest.mark.parametrize("n_shards", [1, 2, 3, 8])
def test_sharded_chunk_equals_single_chunk(street, monkeypatch, n_shards, gated, kind):
    """trace_chunk_sharded over n CPU shards == chunk_body on the whole
    chunk, every output bitwise (the tables padded to 256 x n rays, so the
    last shards hold padding only); gated, each shard sorts its own rays."""
    monkeypatch.setattr(ttrace, "PALLAS_TRI_TILE", 128)
    ps, sp = street
    want_matrix, want_any, discrete = KINDS[kind]
    flags = dict(want_matrix=want_matrix, want_any=want_any, discrete=discrete)
    accel = sp.accel if gated else None
    _, single_args = _chunk_args(ps, sp, RAY_BLOCK, want_any)
    em, args = _chunk_args(ps, sp, RAY_BLOCK * n_shards, want_any)
    assert em.n_rays_pad == RAY_BLOCK * n_shards * -(-480 // (RAY_BLOCK * n_shards))
    single = ttrace.chunk_body(*single_args, accel=accel, **flags)
    sharded = trace_chunk_sharded(cpu_mesh(n_shards), *args, accel=accel, **flags)
    assert sorted(sharded) == sorted(single)
    for key in single:
        assert sharded[key].dtype == torch.int32
        assert torch.equal(sharded[key], single[key]), key
    assert sum(int(v.sum()) for v in single.values()) > 10


@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
def test_padding_only_shard_counts_zero(street, monkeypatch, gated):
    """A shard whose slice lies past n_rays_once (ray_index_base beyond the
    real rays) counts zero in every output, through the plain sweep; the
    shard that holds the real rays counts the whole chunk's hits."""
    monkeypatch.setattr(ttrace, "PALLAS_TRI_TILE", 128)
    ps, sp = street
    em, (pack, mask, tables, geom, cp, n_surf, n_once) = _chunk_args(ps, sp, 8 * RAY_BLOCK,
                                                                     True)
    n_local = em.n_rays_pad // 8
    assert n_once < n_local * 2
    accel = sp.accel if gated else None
    flags = dict(want_matrix=True, want_any=True, discrete=True)
    whole = ttrace.chunk_body(pack, mask, tables, geom, cp, n_surf, n_once, accel=accel,
                              **flags)
    for shard in range(2, 8):
        rows = slice(shard * n_local, (shard + 1) * n_local)
        out = ttrace.chunk_body(pack, mask, tuple(t[rows] for t in tables), geom, cp, n_surf,
                                n_once, accel=accel, ray_index_base=shard * n_local, **flags)
        for key, counts in out.items():
            assert not bool(counts.any()), (shard, key)
    head = [ttrace.chunk_body(pack, mask, tuple(t[s * n_local:(s + 1) * n_local]
                                                for t in tables), geom, cp, n_surf, n_once,
                              accel=accel, ray_index_base=s * n_local, **flags)
            for s in (0, 1)]
    for key in whole:
        assert torch.equal(head[0][key] + head[1][key], whole[key]), key


def _round_inputs(ps, sp):
    """A scheduled round over both street emitters, one iteration each, all
    their blocks: the rows of tests/test_torch_gate.py's gated round."""
    tt, tg, offsets, n_pad = ps.get_flat_tables(samples=2, rays=24, flip_faces=False,
                                                device=CPU)
    emitters = ps.get_emitters(samples=2, rays=24, flip_faces=False)
    rows = [[e, e, int(offsets[e]) + b * RAY_BLOCK, b * RAY_BLOCK]
            for e in range(2) for b in range(int(n_pad[e]) // RAY_BLOCK)]
    ext = np.zeros((2, 3), np.int32)
    for e in range(2):
        ext[e, :2] = _build_emitter_surface_mask(e, emitters[e], *ps.get_mesh_bounds())
    zeros = torch.zeros_like(sp.sid, dtype=torch.bool)
    return (_scene_t(sp), build_tri_pack(_scene_t(sp), zeros, zeros), tt, tg,
            torch.from_numpy(np.concatenate([_cp_rows(3, e, 0, 1) for e in range(2)])),
            torch.from_numpy(ext), torch.tensor([0, 1], dtype=torch.int32),
            torch.tensor([0, 0], dtype=torch.int32),
            torch.tensor([em.n_cells * 24 for em in emitters], dtype=torch.int32),
            torch.from_numpy(np.stack([tprep.emitter_plane_vec(em) for em in emitters])),
            torch.tensor(rows, dtype=torch.int32), torch.tensor([0, 1], dtype=torch.int32))


@pytest.mark.parametrize("kind", ["matrix", "sky_discrete", "matrix_sky"])
@pytest.mark.parametrize("gated", [False, True], ids=["ungated", "gated"])
@pytest.mark.parametrize("n_shards", [1, 3, 8])
def test_sharded_round_equals_single_round(street, n_shards, gated, kind):
    """scheduled_trace_sharded == scheduled_trace, packed counts bitwise,
    on a round of 13 rows, which 3 and 8 shards do not divide."""
    ps, sp = street
    args = _round_inputs(ps, sp)
    assert args[10].shape[0] == 13
    want_matrix, want_any, discrete = KINDS[kind]
    kw = dict(sched_block=RAY_BLOCK, tri_tile=128, accel=sp.accel if gated else None,
              want_matrix=want_matrix, want_any=want_any, discrete=discrete)
    single = ttrace.scheduled_trace(*args, **kw)
    sharded = scheduled_trace_sharded(cpu_mesh(n_shards), *args, **kw)
    assert torch.equal(sharded, single)
    assert int(single.sum()) > 50


# ---------------------------------------------------------------------------
# solves: == mesh=None on both routes
# ---------------------------------------------------------------------------

MP = dict(samples=8, rays=64, seed=4, device="cpu", bvh="off", max_iters=6, min_iters=3,
          tol=1e-3, reciprocity=True)
SP = dict(samples=8, rays=64, seed=4, device="cpu", bvh="off", max_iters=5, min_iters=2,
          tol=1e-3)


@pytest.mark.parametrize("route", ["grouped", "scheduled"])
@pytest.mark.parametrize("n_shards", [2, 3, 8])
def test_sharded_matrix_equals_single(monkeypatch, route, n_shards):
    """view_factor_matrix with a mesh == without, stats too, on each route."""
    params = raystrack_tpu_torch.MatrixParams(**MP)
    base = raystrack_tpu_torch.view_factor_matrix(MESHES, params, return_stats=True)
    monkeypatch.setattr(tconfig, "SCHEDULER", route)
    got = raystrack_tpu_torch.view_factor_matrix(MESHES, params, mesh=cpu_mesh(n_shards),
                                                 return_stats=True)
    assert got == base
    assert sum(len(row) for row in base[0].values()) >= 3


@pytest.mark.parametrize("route", ["grouped", "scheduled"])
@pytest.mark.parametrize("discrete", [False, True], ids=["merged", "discrete"])
def test_sharded_sky_equals_single(monkeypatch, route, discrete):
    params = raystrack_tpu_torch.SkyParams(**SP, discrete=discrete)
    base = raystrack_tpu_torch.view_factor_to_tregenza_sky(MESHES, params)
    monkeypatch.setattr(tconfig, "SCHEDULER", route)
    assert raystrack_tpu_torch.view_factor_to_tregenza_sky(
        MESHES, params, mesh=cpu_mesh(3)) == base


@pytest.mark.parametrize("route", ["grouped", "scheduled"])
def test_sharded_matrix_and_sky_equals_single(monkeypatch, route):
    mp = raystrack_tpu_torch.MatrixParams(**{**MP, "max_iters": 5, "min_iters": 2})
    sp = raystrack_tpu_torch.SkyParams(**SP, discrete=True)
    base = raystrack_tpu_torch.view_factor_matrix_and_sky(MESHES, matrix_params=mp,
                                                          sky_params=sp, return_stats=True)
    monkeypatch.setattr(tconfig, "SCHEDULER", route)
    assert raystrack_tpu_torch.view_factor_matrix_and_sky(
        MESHES, matrix_params=mp, sky_params=sp, mesh=cpu_mesh(8), return_stats=True) == base


@pytest.mark.parametrize("route", ["grouped", "scheduled"])
@pytest.mark.parametrize("shareable", [True, False], ids=["shared_rays", "separate"])
def test_sharded_outside_workflow_equals_single(monkeypatch, route, shareable):
    """The outside workflow with a mesh == without; rows still sum to 1."""
    mp = raystrack_tpu_torch.MatrixParams(**{**MP, "max_iters": 5, "min_iters": 2,
                                             "tol": 5e-3})
    sp = raystrack_tpu_torch.SkyParams(**{**SP, "tol": 5e-3, "seed": 4 if shareable else 6})
    base = view_factor_outside_workflow(MESHES, matrix_params=mp, sky_params=sp)
    monkeypatch.setattr(tconfig, "SCHEDULER", route)
    scene, sky, rest = view_factor_outside_workflow(MESHES, matrix_params=mp, sky_params=sp,
                                                    mesh=cpu_mesh(3))
    assert (scene, sky, rest) == base
    for name, _, _ in MESHES:
        total = sum(scene[name].values()) + sum(sky[name].values()) + rest[name]["Rest"]
        assert abs(total - 1.0) < 1e-9


@pytest.mark.parametrize("route", ["grouped", "scheduled"])
def test_sharded_gated_solve_equals_single(monkeypatch, route):
    """The street with 128-triangle tiles, bvh="builtin": each shard's chunk
    or round is gated, and the dict == the unsharded gated one == off."""
    monkeypatch.setattr(ttrace, "PALLAS_TRI_TILE", 128)
    monkeypatch.setattr(tconfig, "SCHEDULER", route)
    meshes = _street(seed=5)
    params = raystrack_tpu_torch.MatrixParams(samples=2, rays=8, seed=4, device="cpu",
                                              max_iters=3, min_iters=2, tol=1e-3,
                                              reciprocity=False, bvh="builtin")
    base = raystrack_tpu_torch.view_factor_matrix(meshes, params)
    assert raystrack_tpu_torch.view_factor_matrix(meshes, params, mesh=cpu_mesh(3)) == base
    assert sum(len(row) for row in base.values()) >= 2


def test_sharded_slim_pack_equals_full(monkeypatch):
    """A slim (pack-resident) scene sharded over 3 shards == the full-mode
    unsharded solve; the logical mesh keeps one resident pack."""
    params = raystrack_tpu_torch.MatrixParams(**MP)
    full = raystrack_tpu_torch.view_factor_matrix(MESHES, params,
                                                  prepared=tprep.PreparedSolver(MESHES))
    monkeypatch.setattr(tconfig, "SLIM_PACK_MIN_TRIS", 1)
    ps = tprep.PreparedSolver(MESHES)
    slim = raystrack_tpu_torch.view_factor_matrix(MESHES, params, prepared=ps,
                                                  mesh=cpu_mesh(3))
    assert slim == full
    assert [sp.slim for sp in ps._scene_pack_cache.values()] == [True]


def test_logical_mesh_holds_one_copy(monkeypatch):
    """An 8-shard mesh of one device builds each pack once: one scene pack,
    one emitter pack an emitter, and a run's operands on that device only."""
    runs = []

    class Run(tsolver._EmitterRun):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            runs.append(self)

        def release(self):  # keep the operands to count them
            pass

    monkeypatch.setattr(tsolver, "_EmitterRun", Run)
    ps = tprep.PreparedSolver(MESHES)
    raystrack_tpu_torch.view_factor_matrix(
        MESHES, raystrack_tpu_torch.MatrixParams(**{**MP, "reciprocity": False}),
        prepared=ps, mesh=cpu_mesh(8))
    traced = [run for run in runs if run.packs]
    assert len(traced) == 3
    assert len(ps._scene_pack_cache) == 1
    assert len(ps._emitter_pack_cache) == 3
    assert all(set(run.packs) == {(False, CPU)} for run in traced)


@pytest.mark.parametrize("route", ["grouped", "scheduled"])
def test_checkpoint_with_mesh_resumes_at_another_shard_count(monkeypatch, tmp_path, route):
    """A solve on 3 shards stopped after its first emitter, resumed on 8
    shards from the same directory (the fingerprint leaves the mesh out) ==
    the plain solve."""
    monkeypatch.setattr(tconfig, "SCHEDULER", route)
    monkeypatch.setattr(tconfig, "CHECKPOINT_PROGRESS_S", 0)
    params = raystrack_tpu_torch.MatrixParams(**MP)
    plain = raystrack_tpu_torch.view_factor_matrix(MESHES, params)
    real_done = tsolver._entry_done
    finished = []

    class Stop(Exception):
        pass

    def stop_after_first(entry):
        real_done(entry)
        finished.append(entry.idx)
        raise Stop

    monkeypatch.setattr(tsolver, "_entry_done", stop_after_first)
    ckpt = str(tmp_path / "ckpt")
    with pytest.raises(Stop):
        raystrack_tpu_torch.view_factor_matrix(MESHES, params, mesh=cpu_mesh(3),
                                               checkpoint_dir=ckpt)
    monkeypatch.setattr(tsolver, "_entry_done", real_done)
    assert len(finished) == 1
    lines = []
    monkeypatch.setattr(tsolver, "_log", lines.append)
    got = raystrack_tpu_torch.view_factor_matrix(MESHES, params, mesh=cpu_mesh(8),
                                                 checkpoint_dir=ckpt)
    assert got == plain
    assert any("restored from checkpoint" in line for line in lines)


def test_sharded_solve_launches_no_kernel_on_cpu():
    before = sweep_rays.launches
    raystrack_tpu_torch.view_factor_matrix(MESHES, raystrack_tpu_torch.MatrixParams(**MP),
                                           mesh=cpu_mesh(2))
    assert sweep_rays.launches == before == 0


# ---------------------------------------------------------------------------
# against the JAX package's 8-device mesh
# ---------------------------------------------------------------------------


def _assert_close(got, want):
    assert set(got) == set(want)
    for sender in want:
        assert set(got[sender]) == set(want[sender]), sender
        for key, value in want[sender].items():
            assert abs(got[sender][key] - value) <= 1e-4, (sender, key)


def test_sharded_solves_match_jax_mesh():
    """The port's 8-shard matrix and sky against the JAX package's
    ray_mesh() solves over its 8 CPU devices: same key sets, |dF| <= 1e-4."""
    jmesh = jax_ray_mesh()
    assert jmesh.devices.size == 8
    kw = dict(MP, samples=16, rays=128, max_iters=4, min_iters=4)
    want = raystrack_tpu.view_factor_matrix(MESHES, raystrack_tpu.MatrixParams(**kw),
                                            mesh=jmesh)
    got = raystrack_tpu_torch.view_factor_matrix(MESHES, raystrack_tpu_torch.MatrixParams(**kw),
                                                 mesh=cpu_mesh(8))
    _assert_close(got, want)
    skw = dict(SP, samples=16, rays=128, max_iters=4, min_iters=4)
    want = raystrack_tpu.view_factor_to_tregenza_sky(MESHES, raystrack_tpu.SkyParams(**skw),
                                                     mesh=jmesh)
    got = raystrack_tpu_torch.view_factor_to_tregenza_sky(
        MESHES, raystrack_tpu_torch.SkyParams(**skw), mesh=cpu_mesh(8))
    _assert_close(got, want)


# ---------------------------------------------------------------------------
# the mesh itself
# ---------------------------------------------------------------------------


def test_ray_mesh_devices_and_size():
    mesh = ray_mesh(["cpu", CPU, torch.device("cpu")])
    assert mesh.size == 3 and mesh.devices == (CPU,) * 3 and mesh.distinct == (CPU,)
    assert RAY_AXIS == "rays"


def test_mixed_mesh_raises(monkeypatch):
    """cpu and cuda devices in one mesh raise ValueError (a card is faked:
    the check on the types comes after each device's own)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="cannot mix device types"):
        ray_mesh([CPU, torch.device("cuda", 0)])
    with pytest.raises(ValueError, match="at least one device"):
        ray_mesh([])
    with pytest.raises(ValueError, match="cuda or cpu"):
        ray_mesh(["meta"])


def test_ray_mesh_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device|none is available"):
        ray_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ray_mesh(["cuda:0"])


@pytest.mark.parametrize("entry", ["matrix", "sky", "matrix_and_sky", "outside_workflow"])
def test_entry_points_reject_a_mesh_that_is_not_a_ray_mesh(entry):
    """mesh= takes a RayMesh: anything else raises TypeError naming
    ray_mesh(), before any solve; the JAX package's Mesh too."""
    mp = raystrack_tpu_torch.MatrixParams(**MP)
    sp = raystrack_tpu_torch.SkyParams(**SP)
    calls = {
        "matrix": lambda m: raystrack_tpu_torch.view_factor_matrix(MESHES, mp, mesh=m),
        "sky": lambda m: raystrack_tpu_torch.view_factor_to_tregenza_sky(MESHES, sp, mesh=m),
        "matrix_and_sky": lambda m: raystrack_tpu_torch.view_factor_matrix_and_sky(
            MESHES, matrix_params=mp, sky_params=sp, mesh=m),
        "outside_workflow": lambda m: view_factor_outside_workflow(
            MESHES, matrix_params=mp, sky_params=sp, mesh=m),
    }
    for bad in (jax_ray_mesh(), [CPU] * 2):
        with pytest.raises(TypeError, match=r"parallel\.ray_mesh\(\)"):
            calls[entry](bad)


def test_sharded_chunk_rejects_unaligned_tables(street):
    ps, sp = street
    _, args = _chunk_args(ps, sp, RAY_BLOCK, False)
    with pytest.raises(ValueError, match="multiple of RAY_BLOCK"):
        trace_chunk_sharded(cpu_mesh(3), *args)
