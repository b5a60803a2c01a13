"""The port's emitter partitions (``raystrack_tpu_torch.parallel.distribute``).

Modelled on ``tests/test_distribute.py``: merged worker partitions equal
one full solve exactly (the matrix with and without the half-matrix skip
and its post-merge back-fill, the sky merged and discrete, the shared-ray
workflow), on the CPU with the sweeps' plain versions, also with each
worker's rays split over a ray mesh; the workflow partition refuses
parameters it cannot share; ``mesh_area`` equals the emitters' area and the
JAX package's; and the port's partitions agree with the JAX package's
within |dF| <= 1e-4, with the same key sets.
"""
import numpy as np
import pytest
import torch

import raystrack_tpu
import raystrack_tpu.parallel as jpar

import raystrack_tpu_torch
import raystrack_tpu_torch.solver as tsolver
from raystrack_tpu_torch import (
    MatrixParams, SkyParams, merge_vf_matrix, view_factor_matrix, view_factor_matrix_and_sky,
    view_factor_to_tregenza_sky,
)
from raystrack_tpu_torch.parallel import (
    backfill_reciprocity,
    mesh_area,
    partition_emitters,
    ray_mesh,
    view_factor_matrix_partition,
    view_factor_sky_partition,
    view_factor_workflow_partition,
)
from raystrack_tpu_torch.prepared import prepare_emitters


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: beside other test workers, more threads only
    contend for the same cores."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n_threads)


def _square(name, size, z, normal=1, center=(0.0, 0.0)):
    cx, cy = center
    h = size / 2.0
    V = np.array([[cx - h, cy - h, z], [cx + h, cy - h, z], [cx + h, cy + h, z],
                  [cx - h, cy + h, z]], dtype=np.float32)
    F = np.array([[0, 1, 2], [0, 2, 3]] if normal >= 0 else [[0, 2, 1], [0, 3, 2]],
                 dtype=np.int32)
    return name, V, F


MESHES = [
    _square("ground", 2.0, 0.0, normal=+1),
    _square("mid", 1.5, 0.6, normal=-1, center=(0.4, 0.1)),
    _square("top", 3.0, 1.2, normal=-1),
    _square("side", 1.0, 0.3, normal=+1, center=(1.5, 0.0)),
]
BASE = dict(samples=8, rays=64, seed=4, device="cpu", bvh="off", min_iters=3, tol=1e-3)


def _mesh(n_shards):
    return None if n_shards is None else ray_mesh([torch.device("cpu")] * n_shards)


def test_partition_indices():
    assert partition_emitters(11, 3, 0) == [0, 3, 6, 9]
    assert partition_emitters(11, 3, 1) == [1, 4, 7, 10]
    assert partition_emitters(11, 3, 2) == [2, 5, 8]
    seen = sorted(sum((partition_emitters(11, 3, p) for p in range(3)), []))
    assert seen == list(range(11))
    assert partition_emitters(2, 4, 3) == []
    for part in (-1, 3):
        with pytest.raises(ValueError, match="part must be in"):
            partition_emitters(7, 3, part)


@pytest.mark.parametrize("n_shards", [None, 3], ids=["no_mesh", "mesh3"])
@pytest.mark.parametrize("n_parts", [2, 3])
def test_merged_matrix_partitions_equal_full_solve(n_parts, n_shards):
    """reciprocity=False: the merged rows == the full solve's rows."""
    params = MatrixParams(**BASE, max_iters=6, reciprocity=False)
    full = view_factor_matrix(MESHES, params)
    parts = [view_factor_matrix_partition(MESHES, params, n_parts=n_parts, part=p,
                                          mesh=_mesh(n_shards))
             for p in range(n_parts)]
    merged = merge_vf_matrix(parts)
    assert merged == full
    assert sum(len(row) for row in merged.values()) >= 4


@pytest.mark.parametrize("enforce", [False, True], ids=["backfill", "enforced"])
@pytest.mark.parametrize("n_shards", [None, 2], ids=["no_mesh", "mesh2"])
def test_half_matrix_partitions_with_backfill_equal_full_solve(n_shards, enforce):
    """half_matrix=True partitions, merged, then back-filled (and enforced
    as the multi-process helper does) == the plain reciprocity solve."""
    from raystrack_tpu_torch.utils.helpers import enforce_reciprocity_and_rowsum

    params = MatrixParams(**BASE, max_iters=6, reciprocity=True,
                          enforce_reciprocity_rowsum=enforce)
    full = view_factor_matrix(MESHES, params)
    parts = [view_factor_matrix_partition(MESHES, params, n_parts=2, part=p,
                                          mesh=_mesh(n_shards), half_matrix=True)
             for p in range(2)]
    merged = merge_vf_matrix(parts)
    for name, _, _ in MESHES:
        merged.setdefault(name, {})
    backfill_reciprocity(merged, MESHES)
    if enforce:
        enforce_reciprocity_and_rowsum(merged, MESHES,
                                       [mesh_area(V, F) for _, V, F in MESHES])
    assert merged == full


@pytest.mark.parametrize("discrete", [False, True], ids=["merged", "discrete"])
@pytest.mark.parametrize("n_shards", [None, 3], ids=["no_mesh", "mesh3"])
def test_sky_partitions_equal_full_solve(discrete, n_shards):
    sp = SkyParams(**BASE, max_iters=5, discrete=discrete)
    full = view_factor_to_tregenza_sky(MESHES, sp)
    parts = [view_factor_sky_partition(MESHES, sp, n_parts=2, part=p, mesh=_mesh(n_shards))
             for p in range(2)]
    assert merge_vf_matrix(parts) == full
    one = [("only", *MESHES[0][1:])]
    assert view_factor_sky_partition(one, sp, n_parts=1, part=0) == \
        view_factor_to_tregenza_sky(one, sp)


@pytest.mark.parametrize("discrete", [False, True], ids=["merged", "discrete"])
@pytest.mark.parametrize("n_shards", [None, 2], ids=["no_mesh", "mesh2"])
def test_workflow_partitions_equal_full_solve(discrete, n_shards):
    """Merged shared-ray partitions (half-matrix kept on, post-merge
    back-fill) reproduce the single-process workflow exactly; each emitter
    runs the shared state machine of solver._drive_pipelined."""
    mp = MatrixParams(**{**BASE, "min_iters": 2}, max_iters=6, reciprocity=True)
    sp = SkyParams(**{**BASE, "min_iters": 2}, max_iters=5, discrete=discrete)
    vf_full, sky_full = view_factor_matrix_and_sky(MESHES, matrix_params=mp, sky_params=sp)
    vf_parts, sky_parts = [], []
    for p in range(2):
        vf_p, sky_p = view_factor_workflow_partition(MESHES, mp, sp, n_parts=2, part=p,
                                                     mesh=_mesh(n_shards), half_matrix=True)
        vf_parts.append(vf_p)
        sky_parts.append(sky_p)
    vf_merged = merge_vf_matrix(vf_parts)
    for name, _, _ in MESHES:
        vf_merged.setdefault(name, {})
    backfill_reciprocity(vf_merged, MESHES)
    assert vf_merged == vf_full
    assert merge_vf_matrix(sky_parts) == sky_full


def test_drive_monitors_returns_the_iterations_traced():
    """The shared state machine traces as many iterations as the slower
    monitor consumed; a matrix monitor alone as many as it consumed."""
    from raystrack_tpu_torch.convergence import MatrixMonitor, SkyMonitor
    from raystrack_tpu_torch.prepared import PreparedSolver

    ps = PreparedSolver(MESHES)
    p = MatrixParams(**BASE, max_iters=7).as_dict()
    setup = tsolver._setup(MESHES, ps, p, ray_mesh([torch.device("cpu")]), flip_faces=False)
    surf = tsolver._build_emitter_surface_mask(0, setup.emitters[0], *setup.bounds)

    def entry(m_iters, s_iters):
        r = tsolver._emitter_run(setup, 0, surf, 0, 0, lazy=False)
        kw = dict(n_rays_once=r.em_pack.n_rays_once, tol=1e-12, tol_mode="stderr",
                  interval=1)
        m = MatrixMonitor(len(MESHES), np.array([1, 2, 3], np.int32), min_iters=m_iters,
                          max_iters=m_iters, **kw)
        s = SkyMonitor(discrete=False, min_iters=s_iters, max_iters=s_iters, **kw)
        return tsolver._Entry(run=r, idx=0, name=MESHES[0][0], receivers=[1, 2, 3],
                              surf_active=surf, emit_sid=0, min_sid=0, matrix=m,
                              sky=s if s_iters else None)

    e = entry(3, 7)
    tsolver._drive_pipelined([e])
    assert e.trace_iters == 7
    assert (e.matrix.iters_done, e.sky.iters_done, e.run.packs) == (3, 7, {})
    e = entry(5, 0)
    tsolver._drive_pipelined([e])
    assert e.trace_iters == 5


def test_workflow_partition_rejects_incompatible_params():
    mp = MatrixParams(samples=8, rays=64, seed=4, device="cpu")
    sp = SkyParams(samples=4, rays=64, seed=4, device="cpu")
    with pytest.raises(ValueError, match="not compatible"):
        view_factor_workflow_partition(MESHES, mp, sp, n_parts=2, part=0)


def test_mesh_area():
    """mesh_area == the prepared emitter's area exactly, and the JAX
    package's mesh_area."""
    rng = np.random.default_rng(3)
    V = rng.normal(size=(30, 3)).astype(np.float32)
    F = rng.integers(0, 30, size=(40, 3)).astype(np.int32)
    meshes = MESHES + [("cloud", V, F)]
    for (name, V, F), em in zip(meshes, prepare_emitters(meshes, samples=8, rays=64,
                                                        flip_faces=False)):
        assert mesh_area(V, F) == em.total_area == jpar.mesh_area(V, F), name
    assert mesh_area(*MESHES[2][1:]) == pytest.approx(9.0)


def _assert_close(got, want):
    assert set(got) == set(want)
    for sender in want:
        assert set(got[sender]) == set(want[sender]), sender
        for key, value in want[sender].items():
            assert abs(got[sender][key] - value) <= 1e-4, (sender, key)


def test_partitions_match_jax():
    """Each partition of the port against the JAX package's (its XLA sweep
    on the CPU): matrix (half-matrix), sky and workflow rows within 1e-4."""
    kw = dict(BASE, samples=16, rays=128, max_iters=4, min_iters=4)
    for part in range(2):
        got = view_factor_matrix_partition(MESHES, MatrixParams(**kw, reciprocity=True),
                                           n_parts=2, part=part, half_matrix=True)
        want = jpar.view_factor_matrix_partition(
            MESHES, raystrack_tpu.MatrixParams(**kw, reciprocity=True), n_parts=2, part=part,
            half_matrix=True)
        _assert_close(got, want)
        got = view_factor_sky_partition(MESHES, SkyParams(**kw, discrete=True), n_parts=2,
                                        part=part)
        want = jpar.view_factor_sky_partition(MESHES, raystrack_tpu.SkyParams(**kw,
                                                                             discrete=True),
                                              n_parts=2, part=part)
        _assert_close(got, want)
        got = view_factor_workflow_partition(MESHES, MatrixParams(**kw), SkyParams(**kw),
                                             n_parts=2, part=part)
        want = jpar.view_factor_workflow_partition(
            MESHES, raystrack_tpu.MatrixParams(**kw), raystrack_tpu.SkyParams(**kw),
            n_parts=2, part=part)
        for g, w in zip(got, want):
            _assert_close(g, w)


def test_exports_the_jax_parallel_names():
    assert sorted(raystrack_tpu_torch.parallel.__all__) == sorted(jpar.__all__)
    for name in jpar.__all__:
        assert hasattr(raystrack_tpu_torch.parallel, name), name
    assert not hasattr(raystrack_tpu_torch, "ray_mesh")  # as in the JAX package
