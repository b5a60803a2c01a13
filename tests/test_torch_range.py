"""Port parity at the JAX package's documented range (the 10^8-triangle
occluded city of ``docs/measurements/city_100m_r05.py``), on the CPU at
small sizes:

- ``city_100m_torch.city_meshes``, the one copy of the city generator the
  port's scripts share, against the JAX package's ``bench._city``: bitwise;
- a slim scene behind the two-level gate with a ragged last group (40 sweep
  tiles of 128 with ``GATE_MAX_TILES`` = 6: groups of 7 tiles, 6 boxes, the
  last 5 real tiles and 2 phantoms, no early-exit window), the port's gated
  ``chunk_body`` in code mode against the JAX package's
  ``trace_chunk(kernel="pallas", interpret=True)`` and against the port's
  ungated slim chunk: bitwise (the city's axis-aligned boxes put no ray
  near enough to an edge for the ulps between torch's and XLA's sin/cos to
  move it, as ``tests/test_torch_slim.py`` finds on its own boxes);
- on the same two-level gate, the plain sweep's gate counters: every CTA
  walks its block's whole visit list (no window), ``boxes_walked`` ==
  ``boxes_listed``;
- ``city_100m_torch.run``, the script's steps, at a tiny size on the CPU with slim
  and groups of 7 forced: its result keys, gated == ungated inside it, its
  sweep counts bitwise against ``trace_chunk`` on the same inputs, the
  bounded solve within |dF| <= 1e-4 of the JAX package's
  ``view_factor_matrix`` (the tolerance of ``tests/test_torch_slim.py``);
- an import guard: the port, ``chip_smoke.py`` and ``city_100m_torch.py``
  import nothing of JAX, of the JAX package or of ``bench.py``.

Both packages' config is patched as ``tests/test_torch_slim.py`` patches it.
"""
import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raystrack_tpu
import raystrack_tpu.ops.trace as jtrace
import raystrack_tpu.prepared as jprep
from raystrack_tpu import config as jconfig
from raystrack_tpu.solver import _cp_rows

import raystrack_tpu_torch.ops.trace as ttrace
import raystrack_tpu_torch.prepared as tprep
from raystrack_tpu_torch import config as tconfig
from raystrack_tpu_torch.ops.trace_cuda import (
    _resolve_gate_window, gate_group_size, sweep_rays,
)

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import city_100m_torch  # noqa: E402

_spec = importlib.util.spec_from_file_location("bench", ROOT / "bench.py")
bench = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(bench)

CPU = torch.device("cpu")
TILE = 128
MAX_TILES = 6  # 40 tiles -> groups of 7, 6 boxes, the last 5 tiles and 2 phantoms
N_TRI = 5100  # 424 boxes: 5,090 triangles, 5,120 padded = 40 tiles of 128
EXTENT = 40.0  # an 80 x 80 ground: 6,400 cells, 8,192 rays an iteration at samples=1
SAMPLING = dict(samples=1, rays=1, flip_faces=False)


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: beside other test workers, more threads only
    contend for the same cores."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n_threads)


@pytest.fixture
def two_level(monkeypatch):
    """Both packages at sweep tiles of 128, the slim pack and the gate's
    groups of 7."""
    monkeypatch.setattr(ttrace, "PALLAS_TRI_TILE", TILE)
    for cfg in (tconfig, jconfig):
        monkeypatch.setattr(cfg, "GATE_MAX_TILES", MAX_TILES)
        monkeypatch.setattr(cfg, "SLIM_PACK_MIN_TRIS", 1)


def _meshes():
    return city_100m_torch.city_meshes(N_TRI, EXTENT)


def _jax_chunk(meshes, n_rays, n_once, seed, *, gated, want_matrix=True, want_any=False):
    """The JAX package's slim ``trace_chunk`` (Pallas, interpret) of the
    ground (sid 0) on its first ``n_rays`` rays, every other surface a
    receiver: the r05 script's call."""
    jps = jprep.PreparedSolver(meshes)
    jp = jps.get_scene_pack(use_accel=True)
    assert jp.slim
    em = jps.get_emitter_pack(0, **SAMPLING)
    ext = np.zeros(len(meshes) + 1, dtype=np.int32)
    ext[1:-1] = 1
    tables = tuple(t[:n_rays] for t in (em.u_cell, em.v_cell, em.h_tri, em.h_u, em.h_v,
                                         em.h_r1, em.h_r2))
    return jtrace.trace_chunk(
        (None,) * 7 + (jp.sid,), tables,
        (em.cdf, em.tri_a, em.tri_e1, em.tri_e2, em.tri_u, em.tri_v, em.tri_n, em.tri_eps),
        jnp.asarray(_cp_rows(seed, 0, 0, 1)), jnp.asarray(ext), jnp.int32(0), jnp.int32(0),
        jnp.int32(n_once), em.plane_vec, jp.accel if gated else None, jp.tri_pack,
        ray_block=256, tri_tile=TILE, want_matrix=want_matrix, want_any=want_any,
        discrete=False, kernel="pallas", interpret=True)


# ---------------------------------------------------------------------------
# the city generator
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("n_tri", [2, 1_000, 120_000])
def test_city_meshes_equal_bench_city(n_tri, seed):
    got = city_100m_torch.city_meshes(n_tri, seed=seed)
    want = bench._city(n_tri, seed=seed)
    assert [m[0] for m in got] == [m[0] for m in want] == ["ground", "city"]
    for (_, gv, gf), (_, wv, wf) in zip(got, want):
        assert gv.dtype == wv.dtype == np.float32 and gf.dtype == wf.dtype == np.int32
        np.testing.assert_array_equal(gv, wv)
        np.testing.assert_array_equal(gf, wf)
    assert got[1][2].shape[0] == 12 * max(1, (n_tri - 2) // 12)


# ---------------------------------------------------------------------------
# the two-level gate with a ragged last group, on a slim pack
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "want_matrix,want_any", [(True, False), (False, True), (True, True)],
    ids=["matrix", "any", "both"],
)
def test_two_level_slim_chunk_equals_jax_and_ungated(two_level, want_matrix, want_any):
    """The port's gated slim chunk (code mode, groups of 7 with 2 phantom
    tiles) == the JAX package's ``trace_chunk`` (interpret) == the port's
    ungated slim chunk; and the gate skipped tiles."""
    meshes = _meshes()
    ps = tprep.PreparedSolver(meshes)
    pack = ps.get_scene_pack(use_accel=True, device=CPU)
    assert pack.slim and pack.n_tri_pad == 40 * TILE
    assert gate_group_size(40) == 7 and -(-40 // 7) == 6 and _resolve_gate_window(7) == 0
    em = ps.get_emitter_pack(0, device=CPU, **SAMPLING)
    assert em.n_rays_pad == 8192 and em.n_rays_once == 6400
    ext = torch.zeros(3, dtype=torch.int32)
    ext[1] = 1
    mask, bounds = ttrace.slim_operands(pack.sid, ext, 0, 0, want_any=want_any)
    tables = (em.u_cell, em.v_cell, em.h_tri, em.h_u, em.h_v, em.h_r1, em.h_r2)
    geom = (em.cdf, em.tri_a, em.tri_e1, em.tri_e2, em.tri_u, em.tri_v, em.tri_n, em.tri_eps)
    cp = torch.from_numpy(_cp_rows(3, 0, 0, 1))
    flags = dict(want_matrix=want_matrix, want_any=want_any)
    got, ungated = (ttrace.chunk_body(pack.tri_pack, mask, tables, geom, cp, pack.n_surf,
                                      em.n_rays_once, accel=accel, code_bounds=bounds, **flags)
                    for accel in (pack.accel, None))
    want = _jax_chunk(meshes, em.n_rays_pad, em.n_rays_once, 3, gated=True, **flags)
    keys = (["counts_f", "counts_b"] if want_matrix else []) + (["upward"] if want_any else [])
    assert sorted(got) == sorted(ungated) == sorted(keys)
    for key in keys:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]), err_msg=key)
        assert torch.equal(got[key], ungated[key]), key
    if want_matrix:
        assert int(got["counts_b"].sum()) > 1000
    if want_any:
        assert 0 < int(got["upward"].sum()) < em.n_rays_once

    # the same sweep alone: the gate took fewer (block, tile) visits
    o, d = ttrace.generate_rays(tables, geom, cp)
    valid = (torch.arange(em.n_rays_pad) < em.n_rays_once)[None]
    o, d, _ = ttrace._sorted_for_gate(o, d, valid, pack.accel)
    rays = ttrace.ray_pack(o, d)
    visits = {gated: torch.zeros(32, dtype=torch.int32) for gated in (True, False)}
    for gated, v in visits.items():
        sweep_rays(rays, pack.tri_pack, mask, tri_tile=TILE, code_bounds=bounds,
                   accel=pack.accel if gated else None, visits=v, **flags)
    assert int(visits[True].sum()) < int(visits[False].sum())


def test_two_level_gate_walks_every_listed_box(two_level):
    """The plain code-mode sweep behind the two-level gate (groups of 7, no
    early-exit window) under a profiler: every CTA walks its block's whole
    visit list, so ``boxes_walked`` == ``boxes_listed`` == each CTA's
    block's count, summed; each swept tile lies in a walked box's group."""
    from torch.profiler import ProfilerActivity, profile

    from raystrack_tpu_torch import tracing
    from raystrack_tpu_torch.ops import trace_cuda

    ps = tprep.PreparedSolver(_meshes())
    pack = ps.get_scene_pack(use_accel=True, device=CPU)
    em = ps.get_emitter_pack(0, device=CPU, **SAMPLING)
    ext = torch.zeros(3, dtype=torch.int32)
    ext[1] = 1
    mask, bounds = ttrace.slim_operands(pack.sid, ext, 0, 0, want_any=False)
    o, d = ttrace.generate_rays(
        (em.u_cell, em.v_cell, em.h_tri, em.h_u, em.h_v, em.h_r1, em.h_r2),
        (em.cdf, em.tri_a, em.tri_e1, em.tri_e2, em.tri_u, em.tri_v, em.tri_n, em.tri_eps),
        torch.from_numpy(_cp_rows(3, 0, 0, 1)))
    valid = (torch.arange(em.n_rays_pad) < em.n_rays_once)[None]
    o, d, _ = ttrace._sorted_for_gate(o, d, valid, pack.accel)
    rays = ttrace.ray_pack(o, d)[:, :5000].contiguous()
    n = rays.shape[1]
    before = tracing.counts()
    with profile(activities=[ProfilerActivity.CPU]):
        sweep_rays(rays, pack.tri_pack, mask, tri_tile=TILE, code_bounds=bounds,
                   accel=pack.accel, want_matrix=True, want_any=False)
    moved = tracing.since(before)
    gate = trace_cuda._gate_for(pack.accel, rays, pack.n_tri_pad, TILE, TILE, CPU)
    assert gate.group == 7 and gate.window == 0
    geo = trace_cuda._launch_geometry(n, True, CPU)
    per_cta = gate.counts.long()[torch.arange(geo.units(n)) // geo.per_block]
    assert moved["boxes_listed"] == moved["boxes_walked"] == int(per_cta.sum()) > 0
    assert 0 < moved["tiles_swept"] <= 7 * moved["boxes_walked"]


# ---------------------------------------------------------------------------
# the script's steps at a tiny size
# ---------------------------------------------------------------------------


R05_KEYS = {"n_tri", "rays_per_dispatch", "brute_subset_rays", "accel", "brute", "speedup",
            "hits_full_accel", "hits_equal_subset", "solve_3iter_s", "solve_ground_to_city"}


def test_run_at_a_tiny_size_matches_jax(two_level):
    """``city_100m_torch.run`` on the CPU: the r05 keys and the port's; its
    gated and ungated counts (equal, or it raises) bitwise the JAX
    package's ``trace_chunk`` on the same rays; the bounded solve within
    1e-4 of the JAX package's."""
    entry = city_100m_torch.run(N_TRI, CPU, reps=1, extent=EXTENT)
    assert R05_KEYS <= set(entry)
    json.dumps(entry)  # the last line's object
    assert entry["n_tri_pad"] == 40 * TILE and entry["rays_per_dispatch"] == 8192
    assert entry["brute_subset_rays"] == 24 * 256
    assert entry["gate"] == dict(tile=TILE, n_tiles=40, group=7, n_boxes=6, phantoms=2, window=0)
    assert entry["device"] == "cpu" and entry["kernels"] == []
    assert entry["solve_launches"] == dict(k1=0, k1_gated=0, k1_code=0, k2=0, cross=0, count=0)
    counts = entry["sweep_counts"]
    assert counts["accel"] == counts["brute"] and counts["accel_sub"] == counts["brute_sub"]
    meshes = _meshes()
    for label, n_rays, n_once in (("accel", 8192, 6400), ("accel_sub", 6144, 6144)):
        want = _jax_chunk(meshes, n_rays, n_once, 0, gated=True)
        assert counts[label] == [np.asarray(want["counts_f"]).tolist(),
                                 np.asarray(want["counts_b"]).tolist()], label
    assert entry["hits_full_accel"] == sum(counts["accel"][0][0])
    assert sum(counts["accel"][1][0]) > 1000

    params = dict(city_100m_torch.SOLVE, bvh="builtin", device="cpu")
    jps = jprep.PreparedSolver(meshes)
    vf = raystrack_tpu.view_factor_matrix(meshes, raystrack_tpu.MatrixParams(**params),
                                          prepared=jps)
    assert jps.get_scene_pack(use_accel=True).slim
    f_city = sum(v for k, v in vf["ground"].items() if k.startswith("city"))
    assert abs(entry["solve_ground_to_city"] - f_city) <= 1e-4
    assert 0.5 < f_city < 1.0


# ---------------------------------------------------------------------------
# the import guard
# ---------------------------------------------------------------------------


GUARD = """
import sys, torch
sys.path.insert(0, {root!r})
import raystrack_tpu_torch, chip_smoke, city_100m_torch
meshes = city_100m_torch.city_meshes(200, 10.0)
vf = raystrack_tpu_torch.view_factor_matrix(meshes, raystrack_tpu_torch.MatrixParams(
    samples=1, rays=4, seed=1, min_iters=2, max_iters=2, device="cpu"))
assert vf["ground"], vf
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "raystrack_tpu", "bench"))
print("FOREIGN", bad)
"""


def test_port_and_its_scripts_import_nothing_of_jax():
    """A child process imports the port, ``chip_smoke`` and
    ``city_100m_torch`` and solves a tiny city on the CPU: no module of
    ``jax``, ``raystrack_tpu`` or ``bench`` is loaded."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", GUARD.format(root=str(ROOT))], cwd=ROOT,
                         env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "FOREIGN []" in out.stdout.splitlines(), out.stdout
