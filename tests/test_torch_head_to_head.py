"""The port's head-to-head against the reference's BVH
(``head_to_head_torch.py``) against the JAX package's
``benchmarks/head_to_head.py``, on the CPU at small sizes:

- ``materialize_rays`` against the JAX script's rays on the same small
  city: directions within 2e-6 (torch's and XLA's sin/cos differ by ulps,
  the tolerance of ``tests/test_torch_trace.py``); origins within 2 ulps
  of the ground's 40 m edge (7.6e-6), since a point is ``a + b * e1 + c *
  e2`` with ``|e1|, |e2|`` up to 40 and XLA's CPU backend contracts each
  product and sum into one FMA that rounds once where torch rounds twice
  (measured: 4.8e-6 on 0.36% of the coordinates, one ulp of 40 being
  3.8e-6; the 2e-6 of a unit-sized scene is below one ulp here);
- ``write_scene_bin``: given the same rays, byte-identical to the JAX
  script's file;
- where g++ is present: the baseline built into a temporary directory with
  the JAX script's flags and run on the port's CPU rays of a small city:
  its ``hits_front + hits_back`` within 1e-3 (relative) of the port's plain
  checksum (these cities give equal checksums: a difference of 0 rays);
  and ``run`` end to end at a tiny size;
- ``compare`` fails a run at a relative difference of 1e-3; ``main``
  without a card exits 2 and names it.
"""
import importlib.util
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from raystrack_tpu.prepared import PreparedSolver as JPreparedSolver

from raystrack_tpu_torch import PreparedSolver

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import head_to_head_torch as h2h  # noqa: E402

_spec = importlib.util.spec_from_file_location("head_to_head",
                                               ROOT / "benchmarks" / "head_to_head.py")
jh2h = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(jh2h)

CPU = torch.device("cpu")
CITIES = {"2k": (2_000, 20.0), "8k": (8_000, 30.0)}  # triangles, ground half-width


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n_threads)


@pytest.fixture(scope="module")
def baseline(tmp_path_factory):
    """The baseline binary, built once into a temporary directory."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build benchmarks/ref_bvh_baseline.cpp")
    build = tmp_path_factory.mktemp("h2h_build")
    binary = h2h.ensure_binary(build)
    assert binary.parent == build and binary.exists()
    return binary


def _port_rays(meshes, chunk, seed):
    em = PreparedSolver(meshes).get_emitter_pack(0, samples=1, rays=2, flip_faces=False,
                                                 device=CPU)
    return h2h.materialize_rays(em, chunk, seed, CPU)


@pytest.mark.parametrize("chunk,seed", [(2, 0), (1, 5)])
def test_materialize_rays_match_jax(chunk, seed):
    meshes = h2h.city_meshes(*CITIES["2k"])
    o, d = _port_rays(meshes, chunk, seed)
    jem = JPreparedSolver(meshes).get_emitter_pack(0, samples=1, rays=2, flip_faces=False)
    jo, jd = jh2h.materialize_rays(jem, chunk, seed)
    assert o.shape == d.shape == jo.shape == (chunk * 3200, 3)
    assert o.dtype == d.dtype == np.float32
    edge = 2 * CITIES["2k"][1]
    np.testing.assert_allclose(o, jo, rtol=0, atol=2 * float(np.spacing(np.float32(edge))))
    np.testing.assert_allclose(d, jd, rtol=0, atol=2e-6)


@pytest.mark.parametrize("scene", ["city", "soup"])
def test_write_scene_bin_byte_identical_to_jax(tmp_path, scene):
    if scene == "city":
        meshes = h2h.city_meshes(*CITIES["2k"])
    else:
        from bench_torch import soup_meshes
        meshes = soup_meshes(4096)
    o, d = _port_rays(meshes, 2, 3)
    active = np.zeros(len(meshes), np.int32)
    active[1:] = 1
    paths = tmp_path / "port.bin", tmp_path / "jax.bin"
    n = [fn(p, meshes, o, d, active, emit_sid=0, min_sid=0)
         for fn, p in zip((h2h.write_scene_bin, jh2h.write_scene_bin), paths)]
    assert n[0] == n[1] == sum(F.shape[0] for _, _, F in meshes)
    assert paths[0].read_bytes() == paths[1].read_bytes()
    assert paths[0].stat().st_size == 8 + 8 + 4 * 3 + 4 * len(meshes) + n[0] * 52 + o.size * 8


@pytest.mark.parametrize("city", sorted(CITIES))
def test_baseline_hits_match_the_port_checksum(baseline, tmp_path, city, capsys):
    meshes = h2h.city_meshes(*CITIES[city])
    gpu, em = h2h.gpu_point(PreparedSolver(meshes), CPU, 2, 2, 1, 0)
    o, d = h2h.materialize_rays(em, 2, 0, CPU)
    ref = h2h.baseline_point(baseline, meshes, o, d, 2, 1, tmp_path)
    ref_hits = ref["hits_front"] + ref["hits_back"]
    diff = abs(ref_hits - gpu["hits"])
    with capsys.disabled():
        print(f"\n[{city}] port {gpu['hits']} hits, C++ baseline {ref_hits}: "
              f"difference {diff} rays of {gpu['n_rays_valid']}")
    assert ref["n_rays"] == gpu["n_rays_valid"] == len(o)
    assert diff / gpu["hits"] < h2h.MAX_REL_DIFF
    assert gpu["hits"] > 1000
    assert not list(tmp_path.glob("*.bin"))  # the scene file is removed


def test_run_end_to_end_at_a_tiny_size(baseline, tmp_path):
    points = h2h.run([2_000], CPU, threads=2, binary=baseline, work_dir=tmp_path,
                     extent=20.0)
    p = points["2000"]
    assert p["hits_gpu"] == p["hits_ref"] and p["hits_rel_diff"] == 0.0
    assert p["n_rays"] == 6400 and p["n_rays_padded"] == 8192 and p["pad_frac"] == 0.2188
    assert p["ref_threads"] == 2 and len(p["gpu_dispatch_s"]) == 3
    assert p["gpu_launches"] == dict.fromkeys(("k1", "k1_gated", "k2", "k2_gated", "count",
                                               "cross"), 0)  # the CPU runs the plain versions
    assert "| 2,000 |" in h2h.table(points, 2)


def test_compare_fails_at_a_relative_difference_of_1e3():
    gpu = dict(rays_per_sec=2, rays_per_sec_valid=1, hits=10_000, n_rays_valid=1,
               n_rays_padded=2, pad_frac=0.5, dispatch_s=[1.0], launches={})
    ref = dict(hits_front=3, hits_back=10_006, rays_per_sec=4.0, threads=2, build_s=0.0,
               trace_s=0.25, wall_s=0.0)
    assert h2h.compare(1, gpu, ref)["hits_abs_diff"] == 9
    ref["hits_back"] += 1
    with pytest.raises(RuntimeError, match="hit accounting diverged"):
        h2h.compare(1, gpu, ref)


def test_main_without_a_card_exits_nonzero_and_names_it(capsys):
    assert not torch.cuda.is_available()
    assert h2h.main(["--sizes", "10000"]) == 2
    out, err = capsys.readouterr()
    assert "needs a CUDA card" in err and out == ""
