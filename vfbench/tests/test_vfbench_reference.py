"""The frozen scenes against the port-side originals, the plain reference
against ``raystrack_tpu_torch`` on the CPU at small sizes, and the control:
the reference in bfloat16 in the program's place fails each cell's limit.

    python -m pytest vfbench/tests -q
"""
from __future__ import annotations

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
sys.path.insert(0, str(ROOT))

from vfbench import harness  # noqa: E402
from vfbench.scenes import occluded_city, street_canyon  # noqa: E402

# The cells' own traffic at a size the CPU holds: (cell, triangles of the
# city, matrix/sky fields changed). city_building_x4 emits 16 x 160 = 2,560
# rays an iteration, so that of its four shards of 2,048 (RAY_BLOCK x 4
# padded) the second holds real rays, as the cell's do on four cards.
SMALL = {
    "canyon_matrix": (None, dict(samples=1, rays=64, min_iters=5, max_iters=12)),
    "canyon_workflow": (None, dict(samples=1, rays=64, min_iters=5, max_iters=12)),
    "city_building": (12_002, dict(rays=64)),
    "city_buildings": (12_002, dict(rays=8, min_iters=2, max_iters=2)),
    "city_building_x4": (12_002, dict(rays=160)),
}


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def small_cell(name):
    cell = harness.Cell.load(name)
    n_tri, fields = SMALL[name]
    if n_tri:
        cell.config = {**cell.config, "triangles": n_tri}
    for side in ("matrix", "sky"):
        if side in cell.traffic:
            cell.traffic = {**cell.traffic, side: {**cell.traffic[side], **fields}}
    return cell


def test_canyon_is_the_upstream_example():
    from examples.ex00_street_canyon_geometry import build_street_canyon

    config = harness.Cell.load("canyon_matrix").config
    ours, theirs = street_canyon.build(config, 12345), build_street_canyon()
    assert [m[0] for m in ours] == [m[0] for m in theirs]
    for (_, v, f), (_, v2, f2) in zip(ours, theirs):
        assert v.dtype == v2.dtype and f.dtype == f2.dtype
        assert np.array_equal(v, v2) and np.array_equal(f, f2)


@pytest.mark.parametrize("seed", [0, 2147483901])
def test_city_is_the_jax_bench_city(seed):
    from city_100m_torch import city_meshes

    ours, theirs = occluded_city.city_meshes(120_002, 100.0, seed), city_meshes(120_002, 100.0,
                                                                                 seed)
    for (n, v, f), (n2, v2, f2) in zip(ours, theirs):
        assert n == n2 and np.array_equal(v, v2) and np.array_equal(f, f2)


@pytest.mark.parametrize("per_building", [1, 16])
def test_buildings_split_the_city(per_building):
    config = {"triangles": 120_002, "extent": 100.0}
    whole = occluded_city.city_meshes(120_002, 100.0, 5)
    split = occluded_city.build(config, 5, buildings=[[0.0, 0.0], [50.0, 50.0]],
                                boxes_per_building=per_building)
    assert [m[0] for m in split] == ["bld_0", "bld_1", "city"]
    boxes = whole[1][1].reshape(-1, 8, 3)
    parts = [split[0][1], split[1][1], split[2][1][4:]]
    assert [p.shape[0] // 8 for p in parts[:2]] == [per_building] * 2
    together = np.concatenate([p.reshape(-1, 8, 3) for p in parts])
    assert np.array_equal(np.unique(together.reshape(-1, 24), axis=0),
                          np.unique(boxes.reshape(-1, 24), axis=0))
    assert np.array_equal(split[2][1][:4], whole[0][1])
    assert sum(m[2].shape[0] for m in split) == sum(m[2].shape[0] for m in whole)
    for _, V, F in split:
        assert F.min() == 0 and F.max() == V.shape[0] - 1


@pytest.mark.parametrize("name", list(SMALL))
def test_reference_agrees_with_the_port_and_the_control_fails(name):
    cell = small_cell(name)
    meshes = cell.meshes(2147483901)
    solve = harness.program_solver(cell.traffic, meshes, "cpu", cell.chips)
    limit = float(cell.limits["gap"])
    for qmc in (harness.solve_seed(7, 1), harness.solve_seed(7, 2)):
        got = solve(qmc)
        want = harness.reference_solve(cell.traffic, meshes, qmc, "cpu")
        assert harness.widest_gap(got, want) <= 1e-9
        control = harness.reference_solve(cell.traffic, meshes, qmc, "cpu", torch.bfloat16)
        assert harness.widest_gap(control, want) > limit
        run = harness.Run(cell=cell, seed=7, walls=[0.0])  # as control.py judges it
        harness.check(run, meshes, [control], [qmc], "cpu")
        assert run.checks["gap"]["value"] > limit and not run.correct
