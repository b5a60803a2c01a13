"""Port parity: ray generation, the sweep and one chunk of the solve.

The JAX side runs as its own tests run it on the CPU: the Pallas sweep in
interpret mode, the chunk step through the XLA sweep. Inputs come from
NumPy seeds and identical packs (carried across with ``interop``).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raystrack_tpu.ops.trace as jtrace
import raystrack_tpu.ops.trace_pallas as jpallas
import raystrack_tpu.prepared as jprep
from raystrack_tpu.config import RAY_BLOCK
from raystrack_tpu.solver import _build_emitter_surface_mask, _cp_rows, _matrix_skip

import raystrack_tpu_torch.ops.trace as ttrace
import raystrack_tpu_torch.prepared as tprep
from raystrack_tpu_torch.interop import emitter_pack_from_arrays, scene_pack_from_arrays
from raystrack_tpu_torch.ops.trace_cuda import build_tri_pack, sweep_rays

CPU = torch.device("cpu")


def _square(name, size, z, normal=1, center=(0.0, 0.0)):
    cx, cy = center
    h = size / 2.0
    V = np.array(
        [[cx - h, cy - h, z], [cx + h, cy - h, z], [cx + h, cy + h, z],
         [cx - h, cy + h, z]],
        dtype=np.float32,
    )
    F = np.array([[0, 1, 2], [0, 2, 3]] if normal >= 0 else [[0, 2, 1], [0, 3, 2]],
                 dtype=np.int32)
    return name, V, F


def _three_squares():
    return [
        _square("emitter", 1.0, 0.0),
        _square("mid", 1.5, 0.7, normal=-1, center=(0.3, -0.2)),
        _square("top", 3.0, 1.3, normal=+1, center=(-0.4, 0.1)),
    ]


def _cloud(n_tri, seed, lo=-3.0, hi=3.0):
    rng = np.random.default_rng(seed)
    V = rng.uniform(lo, hi, (n_tri * 3, 3)).astype(np.float32)
    return V, np.arange(n_tri * 3, dtype=np.int32).reshape(-1, 3)


def _plate_and_cloud():
    """A 4 x 4 plate emitter under a 700-triangle cloud (Morton-ordered)."""
    _, V, F = _square("plate", 4.0, 0.0)
    Vc, Fc = _cloud(700, 5, 0.2, 3.0)
    Vc[:, :2] -= 1.6
    return [("plate", V, F), ("cloud", Vc, Fc)]


def _arrays(pack):
    return {
        f.name: (getattr(pack, f.name) if isinstance(getattr(pack, f.name), int)
                 else None if getattr(pack, f.name) is None
                 else np.asarray(getattr(pack, f.name)))
        for f in dataclasses.fields(pack)
    }


def _scene_t(p):
    return (p.v0, p.e1, p.e2, p.cross_e, p.w_u, p.w_v, p.d0, p.sid)


def _tables_t(e):
    return (e.u_cell, e.v_cell, e.h_tri, e.h_u, e.h_v, e.h_r1, e.h_r2)


def _geom_t(e):
    return (e.cdf, e.tri_a, e.tri_e1, e.tri_e2, e.tri_u, e.tri_v, e.tri_n, e.tri_eps)


# ---------------------------------------------------------------------------
# (b) ray generation
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("scene,idx", [("squares", 0), ("squares", 2), ("plate", 0)])
def test_generate_rays_matches_jax(scene, idx):
    """Within atol 2e-6: jnp and torch sin/cos differ by ulps on ~5% of f32
    inputs, and XLA's CPU backend contracts a*b + c into FMAs."""
    meshes = _three_squares() if scene == "squares" else _plate_and_cloud()
    jem = jprep.PreparedSolver(meshes).get_emitter_pack(
        idx, samples=8, rays=32, flip_faces=False
    )
    tem = emitter_pack_from_arrays(_arrays(jem), CPU)
    cp = _cp_rows(3, idx, 0, 3)
    o_t, d_t = ttrace.generate_rays(_tables_t(tem), _geom_t(tem), torch.from_numpy(cp))
    for k in range(cp.shape[0]):
        o_j, d_j = jtrace.generate_rays(_tables_t(jem), _geom_t(jem), jnp.asarray(cp[k]))
        np.testing.assert_allclose(o_t[k].numpy(), np.asarray(o_j), rtol=0, atol=2e-6)
        np.testing.assert_allclose(d_t[k].numpy(), np.asarray(d_j), rtol=0, atol=2e-6)


# ---------------------------------------------------------------------------
# masks and the operand pack
# ---------------------------------------------------------------------------


def _sweep_scene():
    """Three surfaces of 128 small random triangles each: emitter (sid 0,
    its whole tile excluded), low (sid 1: any-hit only), cloud (sid 2)."""
    meshes = []
    for sid, name in enumerate(("emitter", "low", "cloud")):
        rng = np.random.default_rng(10 + sid)
        centers = rng.uniform(-3, 3, (128, 1, 3))
        V = (centers + rng.normal(scale=0.6, size=(128, 3, 3))).reshape(-1, 3)
        meshes.append((name, V.astype(np.float32),
                       np.arange(384, dtype=np.int32).reshape(-1, 3)))
    return meshes


def test_masks_and_tri_pack_match_jax():
    meshes = _three_squares()
    jps = jprep.PreparedSolver(meshes)
    jsc = jps.get_scene_pack()
    tsc = scene_pack_from_arrays(_arrays(jsc), CPU)
    jem = jps.get_emitter_pack(0, samples=8, rays=32, flip_faces=False)
    ext = np.array([0, 1, 1, 0], np.int32)
    jm = jtrace.compute_masks(_scene_t(jsc), jnp.asarray(ext), jnp.int32(0),
                              jnp.int32(1), jem.plane_vec)
    tm = ttrace.compute_masks(_scene_t(tsc), torch.from_numpy(ext), 0, 1,
                              torch.from_numpy(np.array(jem.plane_vec)))
    for a, b in zip(jm, tm):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for bake in (None, 1):
        jp = jpallas.build_tri_pack(_scene_t(jsc), *jm,
                                    bake=None if bake is None else jm[bake])
        tp = build_tri_pack(_scene_t(tsc), *tm, bake=None if bake is None else tm[bake])
        np.testing.assert_array_equal(np.asarray(jp), tp.numpy())


# ---------------------------------------------------------------------------
# (c) the sweep against the Pallas kernel in interpret mode
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("baked", [True, False], ids=["baked", "rows"])
@pytest.mark.parametrize(
    "want_matrix,want_any", [(True, False), (False, True), (True, True)],
    ids=["matrix", "any", "both"],
)
def test_sweep_matches_pallas_interpret(want_matrix, want_any, baked):
    """Codes and any-hit flags equal the Pallas kernel's; expected bitwise,
    at most 0.1% of rays may differ because XLA's CPU backend contracts the
    kernel's a*b + c sums into FMAs where PyTorch rounds each product.
    Tiles of 128 over 384 triangles exercise the cross-tile tie rule and
    the skip of the emitter's all-ineligible tile."""
    jsc = jprep.PreparedSolver(_sweep_scene()).get_scene_pack()
    ext = jnp.asarray(np.array([1, 1, 1, 0], np.int32))
    m_any, m_mat = jtrace.compute_masks(_scene_t(jsc), ext, jnp.int32(0), jnp.int32(2))
    prim = m_any if want_any else m_mat
    pack = jpallas.build_tri_pack(_scene_t(jsc), m_any, m_mat,
                                  bake=prim if baked else None)

    rng = np.random.default_rng(7)
    n = 8192
    o = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    rays = np.concatenate([o, d, np.cross(o, d)], axis=1).astype(np.float32).T.copy()

    kw = dict(tri_tile=128, want_matrix=want_matrix, want_any=want_any,
              masks_baked=baked)
    cj, aj = jpallas.sweep_rays(jnp.asarray(rays), pack, prim, ray_block=256,
                                interpret=True, **kw)
    ct, at = sweep_rays(torch.from_numpy(rays), torch.from_numpy(np.array(pack)),
                        torch.from_numpy(np.array(prim)), **kw)
    cj, aj = np.asarray(cj), np.asarray(aj)
    assert (ct.numpy() != cj).sum() <= n // 1000
    assert (at.numpy() != aj).sum() <= n // 1000
    if want_matrix:
        assert (cj >= 0).sum() > 500  # the scene is really hit
        assert set(np.unique(cj[cj >= 0]) // 2) == {2}  # only matrix-eligible sid
    if want_any:
        assert aj.sum() > 500


# ---------------------------------------------------------------------------
# (f) wrapper contract
# ---------------------------------------------------------------------------


def _valid_sweep_args():
    pack = torch.zeros((24, 256), dtype=torch.float32)
    return torch.zeros((9, 64), dtype=torch.float32), pack, torch.ones(256, dtype=torch.bool)


@pytest.mark.parametrize(
    "case,error",
    [
        ("rays_f64", TypeError),
        ("rays_shape", ValueError),
        ("rays_noncontig", ValueError),
        ("pack_rows", ValueError),
        ("pack_width", ValueError),
        ("mask_dtype", TypeError),
        ("no_output", ValueError),
    ],
)
def test_sweep_wrapper_rejects(case, error):
    rays, pack, mask = _valid_sweep_args()
    kw = dict(tri_tile=2048, want_matrix=True, want_any=False)
    if case == "rays_f64":
        rays = rays.double()
    elif case == "rays_shape":
        rays = torch.zeros((8, 64), dtype=torch.float32)
    elif case == "rays_noncontig":
        rays = torch.zeros((64, 9), dtype=torch.float32).T
    elif case == "pack_rows":
        pack = torch.zeros((23, 256), dtype=torch.float32)
    elif case == "pack_width":
        pack, mask = torch.zeros((24, 200)), torch.ones(200, dtype=torch.bool)
    elif case == "mask_dtype":
        mask = mask.to(torch.int32)
    elif case == "no_output":
        kw["want_matrix"] = False
    with pytest.raises(error):
        sweep_rays(rays, pack, mask, **kw)


def test_cpu_sweep_uses_plain_version_and_counts_no_launch():
    before = sweep_rays.launches
    rays, pack, mask = _valid_sweep_args()
    codes, any_hit = sweep_rays(rays, pack, mask, tri_tile=2048,
                                want_matrix=True, want_any=True)
    assert codes.dtype == any_hit.dtype == torch.int32
    assert codes.shape == any_hit.shape == (64,)
    assert bool((codes == -1).all()) and not bool(any_hit.any())
    assert sweep_rays.launches == before == 0


# ---------------------------------------------------------------------------
# (d) one chunk against the JAX package's XLA chunk step
# ---------------------------------------------------------------------------


@pytest.mark.parametrize(
    "scene,idx,reciprocity,accel",
    [("squares", 0, True, False), ("squares", 1, False, False),
     ("plate", 0, True, True)],
)
def test_chunk_counts_match_trace_chunk(scene, idx, reciprocity, accel):
    """Per surface and iteration |dcount| <= max(2, 0.001 * n_rays): rays
    agree to ulps (see test_generate_rays_matches_jax), so only rays within
    an ulp of a triangle edge may land differently."""
    meshes = _three_squares() if scene == "squares" else _plate_and_cloud()
    jps = jprep.PreparedSolver(meshes)
    jsc = jps.get_scene_pack(use_accel=accel)
    jem = jps.get_emitter_pack(idx, samples=8, rays=32, flip_faces=False)
    emitter = jps.get_emitter(idx, samples=8, rays=32, flip_faces=False)
    surf_active = _build_emitter_surface_mask(idx, emitter, *jps.get_mesh_bounds())
    ext = np.zeros(len(meshes) + 1, np.int32)
    ext[:-1] = surf_active
    emit_sid, min_sid = _matrix_skip(idx, reciprocity)
    cp = _cp_rows(11, idx, 0, 4)

    want = jtrace.trace_chunk(
        _scene_t(jsc), _tables_t(jem), _geom_t(jem), jnp.asarray(cp), jnp.asarray(ext),
        jnp.int32(emit_sid), jnp.int32(min_sid), jnp.int32(jem.n_rays_once),
        jem.plane_vec, jsc.accel, jsc.tri_pack,
        ray_block=RAY_BLOCK, tri_tile=jsc.tri_tile, want_matrix=True,
        want_any=False, discrete=False, kernel="xla",
    )
    tsc = scene_pack_from_arrays(_arrays(jsc), CPU)
    tem = emitter_pack_from_arrays(_arrays(jem), CPU)
    operands = ttrace.emitter_operands(
        _scene_t(tsc), torch.from_numpy(ext), emit_sid, min_sid, tem.plane_vec
    )
    got = ttrace.chunk_body(
        *operands, _tables_t(tem), _geom_t(tem), torch.from_numpy(cp),
        tsc.n_surf, tem.n_rays_once,
    )
    tol = max(2, int(0.001 * jem.n_rays_once))
    for key in ("counts_f", "counts_b"):
        a, b = np.asarray(want[key]), got[key].numpy()
        assert a.shape == b.shape == (4, len(meshes))
        assert np.abs(a.astype(np.int64) - b).max() <= tol, key
    assert np.asarray(want["counts_f"]).sum() + np.asarray(want["counts_b"]).sum() > 0


def test_port_packs_drive_the_same_chunk():
    """The port's own packs (no interop) give exactly the interop'd counts."""
    meshes = _plate_and_cloud()
    jps, tps = jprep.PreparedSolver(meshes), tprep.PreparedSolver(meshes)
    kw = dict(samples=8, rays=32, flip_faces=False)
    ext = torch.tensor([0, 1, 0], dtype=torch.int32)
    cp = torch.from_numpy(_cp_rows(2, 0, 0, 2))
    outs = []
    for sc, em in (
        (tps.get_scene_pack(use_accel=True, device=CPU),
         tps.get_emitter_pack(0, device=CPU, **kw)),
        (scene_pack_from_arrays(_arrays(jps.get_scene_pack(use_accel=True)), CPU),
         emitter_pack_from_arrays(_arrays(jps.get_emitter_pack(0, **kw)), CPU)),
    ):
        operands = ttrace.emitter_operands(_scene_t(sc), ext, 0, 1, em.plane_vec)
        outs.append(ttrace.chunk_body(*operands, _tables_t(em), _geom_t(em), cp,
                                      sc.n_surf, em.n_rays_once))
    for key in ("counts_f", "counts_b"):
        assert torch.equal(outs[0][key], outs[1][key])
    assert int(outs[0]["counts_f"].sum() + outs[0]["counts_b"].sum()) > 0
