#!/usr/bin/env python3
"""Headline benchmark of the PyTorch / CUDA port on one NVIDIA card: the
port's counterpart of the JAX package's ``bench.py``.

It runs ``bench.py``'s workloads, at ``bench.py``'s sizes, through
``raystrack_tpu_torch`` on the card, and prints the same two-line structure:
the headline JSON line as soon as the headline is measured (flushed), then
the secondaries, each under the global wall-clock budget, with the enriched
line reprinted after every stage:

  {"metric": "ray_triangle_tests_per_sec", "value": N, "unit": "tests/s",
   "vs_baseline": N / 1e9, ...}

The baseline is BASELINE.json's north star, 1e9 ray-triangle tests/s.

- headline: one fused dispatch (``ops.trace.chunk_body``: masks and the
  baked pack, raygen, kernel #1 ungated, the count kernel) of 4 iterations
  of 65,536 rays against the 98,304-triangle soup (no padding: every
  counted test is a real one), best of 5; tests = rays x padded triangles;
- ``district_97_emitters_solve_s``: the 97-emitter district's warm matrix
  solve (the scheduled route, kernel #2), best of 3, at least 90 non-empty
  rows;
- ``occluded_city_rays_per_sec``: rays/s of the occluded city at 1e7, 1e6,
  1e5 and 1e4 triangles (the 1e7 point first), gated (kernel #1 behind the
  AABB gate and its crossing kernel) and brute force. At 1e4-1e6 the brute
  and gated hit counts must be equal; at 1e7 the gated checksum is held to
  the calibration for this card in ``bench_expected_torch.json``, keyed by
  the card's name (``--calibrate`` rewrites it from a live brute run; with
  no entry for the card the brute run is live);
- ``canyon_solve_s``: the 22-triangle street canyon's warm solve, best of
  3; ``parallel_plates_abs_err``: |F - 0.1998248957| of two unit plates.

Every timed run of a solve is printed on a ``#`` note line beside the best.
Rays are counted padded (``n_rays_pad``), as ``bench.py`` counts them; the
city entries also give the real rays of a dispatch. Each stage notes the
launches it made of kernel #1, kernel #2, the count kernel and the gate's
crossing kernel, read from the port's launch counters, and the enriched
line carries them under ``launches``.

Budget: the whole run is held to RAYSTRACK_TPU_BENCH_BUDGET_S seconds
(default 420). A secondary whose estimated cost (from the card's own
set-up and solve times) exceeds what is left is skipped with a note. A
stage that raises is noted, the enriched line is still printed, and the
script then exits 1.

It needs a CUDA card: without one it exits 2 and says so. It imports
nothing of JAX.

Usage: python3 bench_torch.py [--calibrate]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from city_100m_torch import card_line, city_meshes, operands

ROOT = Path(__file__).resolve().parent
N_TRI = 98304  # the soup: a multiple of the tile width, so no padding
RAYS_PER_CELL = 256
SAMPLES = 1  # a 16 x 16 emitter: g = 16, 65,536 rays an iteration
CHUNK = 4
REPS = 5
BASELINE_TESTS_PER_SEC = 1.0e9
BUDGET_VAR = "RAYSTRACK_TPU_BENCH_BUDGET_S"
DEFAULT_BUDGET_S = 420.0
EXPECTED_PATH = ROOT / "bench_expected_torch.json"
CITY_SIZES = (10_000_000, 1_000_000, 100_000, 10_000)  # the flagship 1e7 point first
CALIBRATED_TRIS = 10_000_000  # from here on the brute anchor is the calibration
# Estimated seconds of each stage on the card, about twice what each took
# on an NVIDIA H100 80GB HBM3 at 700 W (scene generation, set-up and the
# timed runs; PERF.md section 5): the 1e7 point 16.4 s gated only, 26.1 s
# with its brute pack (--calibrate); 1e6 3.9 s; 1e5 0.4 s; 1e4 0.1 s; the
# district 0.9 s; the canyon and the plates 0.4 s.
CITY_EST_S = {10_000_000: 35, 1_000_000: 8, 100_000: 2, 10_000: 1}
CITY_CALIBRATE_EST_S = 60  # the 1e7 point with its brute pack's set-up and runs
DISTRICT_EST_S = 5
CANYON_PLATES_EST_S = 5
PLATES_EXACT = 0.1998248957
LAUNCH_KEYS = ("k1", "k1_gated", "k2", "k2_gated", "count", "cross")


class Budget:
    """Wall-clock seconds left of ``seconds`` since construction."""

    def __init__(self, seconds: float):
        self.seconds = seconds
        self.start = time.monotonic()

    def remaining(self) -> float:
        return self.seconds - (time.monotonic() - self.start)


def note(msg: str) -> None:
    print(f"# {msg}", flush=True)


def check(ok: bool, msg: str) -> None:
    """An honesty check: raises (never an ``assert``, which ``-O`` drops)."""
    if not ok:
        raise RuntimeError(msg)


def soup_meshes(n_tri: int = N_TRI):
    """Emitter plate + an (n_tri - 2)-triangle cloud above it (peak regime:
    sparse cloud, nothing prunable, pure pair-test throughput): the JAX
    package's ``bench._bench_soup``."""
    h = 8.0
    V = np.array([[-h, -h, 0], [h, -h, 0], [h, h, 0], [-h, h, 0]], np.float32)
    F = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    rng = np.random.default_rng(0)
    n_cloud = n_tri - 2
    centers = rng.uniform([-8, -8, 2], [8, 8, 30], size=(n_cloud, 3))
    spans = rng.normal(scale=0.4, size=(n_cloud, 2, 3))
    Vc = np.concatenate(
        [centers, centers + spans[:, 0], centers + spans[:, 1]], axis=1
    ).reshape(-1, 3).astype(np.float32)
    Fc = np.arange(n_cloud * 3, dtype=np.int32).reshape(-1, 3)
    return [("emitter", V, F), ("cloud", Vc, Fc)]


def district_meshes(n_buildings: int = 96, extent: float = 60.0, seed: int = 3):
    """Ground + one 12-triangle mesh per building, so a matrix solve runs
    n_buildings + 1 emitters over more than 512 triangles: the JAX
    package's ``bench._district``."""
    rng = np.random.default_rng(seed)
    V = np.array([[-extent, -extent, 0], [extent, -extent, 0],
                  [extent, extent, 0], [-extent, extent, 0]], np.float32)
    F = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    box_f = np.array([[0, 1, 2], [0, 2, 3], [4, 6, 5], [4, 7, 6],
                      [0, 4, 5], [0, 5, 1], [1, 5, 6], [1, 6, 2],
                      [2, 6, 7], [2, 7, 3], [3, 7, 4], [3, 4, 0]], np.int32)
    meshes = [("ground", V, F)]
    cx = rng.uniform(-extent * 0.9, extent * 0.9, (n_buildings, 2))
    w = rng.uniform(1.5, 5.0, (n_buildings, 2))
    h = rng.uniform(4.0, 30.0, n_buildings)
    for i in range(n_buildings):
        x0, y0 = cx[i] - w[i]
        x1, y1 = cx[i] + w[i]
        vs = np.array([[x0, y0, 0.05], [x1, y0, 0.05], [x1, y1, 0.05],
                       [x0, y1, 0.05], [x0, y0, h[i]], [x1, y0, h[i]],
                       [x1, y1, h[i]], [x0, y1, h[i]]], np.float32)
        meshes.append((f"bld_{i:03d}", vs, box_f.copy()))
    return meshes


def launches() -> dict:
    """The port's launch counters now, by LAUNCH_KEYS: kernel #1 (and its
    gated launches), kernel #2 (and its gated ones), the count kernel, the
    gate's crossing kernel."""
    from raystrack_tpu_torch.ops.count_cuda import count_bins
    from raystrack_tpu_torch.ops.trace_cuda import gate_cross, sweep_rays, sweep_rays_scheduled

    return dict(zip(LAUNCH_KEYS, (sweep_rays.launches, sweep_rays.gated_launches,
                                  sweep_rays_scheduled.launches,
                                  sweep_rays_scheduled.gated_launches, count_bins.launches,
                                  gate_cross.launches)))


def launches_since(before: dict) -> dict:
    now = launches()
    return {k: now[k] - before[k] for k in LAUNCH_KEYS}


def solve_device(dev: torch.device) -> str:
    """``MatrixParams.device`` for ``dev``."""
    return "gpu" if dev.type == "cuda" else "cpu"


def run_chunk(ps, dev: torch.device, *, accel: bool, seed: int, chunk: int, samples: int,
              rays: int):
    """One fused dispatch of emitter 0 (``bench._run_chunk``): the scene
    pack (Morton-ordered with its boxes when ``accel``), every surface but
    the emitter a receiver, no half-matrix cut and no plane cull; the baked
    pack (a slim scene: its resident pack and code bounds), ``chunk``
    iterations of rays from the CP rows of ``seed``, kernel #1 (gated where
    the boxes prune), the count kernel. Returns (outputs left on ``dev``,
    the emitter pack, the scene pack)."""
    from raystrack_tpu_torch.ops import trace as T
    from raystrack_tpu_torch.solver import _cp_rows, _emission_geometry, _ray_tables

    scene = ps.get_scene_pack(use_accel=accel, device=dev)
    em = ps.get_emitter_pack(0, samples=samples, rays=rays, flip_faces=False, device=dev)
    tri_pack, mask, bounds = operands(scene, dev)
    cp = torch.from_numpy(_cp_rows(seed, 0, 0, chunk)).to(dev)
    out = T.chunk_body(tri_pack, mask, _ray_tables(em), _emission_geometry(em), cp,
                       scene.n_surf, em.n_rays_once, accel=scene.accel, code_bounds=bounds)
    return out, em, scene


def force(out) -> int:
    """A device-to-host copy of the (small) front counts: a hard sync.
    Returns their sum, the front hits."""
    return int(out["counts_f"].cpu().numpy().sum())


def timed_runs(run, seeds) -> list:
    """Wall seconds of ``force(run(seed)[0])`` for each seed."""
    times = []
    for seed in seeds:
        t0 = time.perf_counter()
        force(run(seed)[0])
        times.append(time.perf_counter() - t0)
    return times


def headline(dev: torch.device, *, n_tri: int = N_TRI, rays: int = RAYS_PER_CELL,
             reps: int = REPS):
    """(tests/s, rays/s, padded triangles, the emitter pack, each timed
    dispatch's seconds) of the soup dispatch, best of ``reps`` after one
    warm-up (which builds the kernels at first use)."""
    from raystrack_tpu_torch import PreparedSolver

    ps = PreparedSolver(soup_meshes(n_tri))
    run = lambda seed: run_chunk(ps, dev, accel=False, seed=seed, chunk=CHUNK,  # noqa: E731
                                 samples=SAMPLES, rays=rays)
    out, em, scene = run(0)
    force(out)
    times = timed_runs(run, range(1, reps + 1))
    tests = CHUNK * em.n_rays_pad * scene.n_tri_pad
    return tests / min(times), CHUNK * em.n_rays_pad / min(times), scene.n_tri_pad, em, times


def device_name(dev: torch.device) -> str:
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


def platform_key(dev: torch.device) -> str:
    """The calibration's key: the card's name, spaces as underscores."""
    return device_name(dev).replace(" ", "_")


def load_expected(path: Path = EXPECTED_PATH) -> dict:
    """The committed calibrations (``bench_expected_torch.json``); {} when
    there is none yet."""
    if not path.exists():
        return {}
    return json.loads(path.read_text(encoding="utf-8"))


def city_point(n_tri: int, dev: torch.device, *, calibrate: bool, expected: dict,
               extent: float = 100.0) -> dict:
    """Rays/s at one occluded-city size, gated and brute force, and the hit
    counts that keep the gate honest (``bench._city_point``). Below
    ``CALIBRATED_TRIS`` the brute run is live and its front and back counts
    must equal the gated ones; from there on, unless ``calibrate`` or the
    card has no calibration, the gated counts must equal the calibrated
    ones and the brute rate is the calibration's. The device packs of each
    mode are dropped before the next is built."""
    from raystrack_tpu_torch import PreparedSolver

    big = n_tri >= CALIBRATED_TRIS
    chunk, rays, reps = (1, 1, 2) if big else (2, 2, 3)
    cal = expected.get(platform_key(dev), {}).get(str(n_tri)) if big else None
    run_brute = (not big) or calibrate or cal is None

    entry: dict = {}
    hits: dict = {}
    ps = PreparedSolver(city_meshes(n_tri, extent))
    for accel in ((False, True) if run_brute else (True,)):
        mode = "accel" if accel else "brute"
        run = lambda seed: run_chunk(ps, dev, accel=accel, seed=seed,  # noqa: E731
                                     chunk=chunk, samples=1, rays=rays)
        out, em, _ = run(0)
        hits[accel] = (force(out), int(out["counts_b"].cpu().numpy().sum()))
        times = timed_runs(run, range(1, reps + 1))
        note(f"city[{n_tri}] {mode} runs: {', '.join(f'{t:.6f}' for t in times)} s")
        entry[mode] = round(chunk * em.n_rays_pad / min(times))
        del out, run
        ps.clear_device_cache()
    entry.update(hits=hits[True][0], hits_back=hits[True][1],
                 rays_per_dispatch=chunk * em.n_rays_pad,
                 valid_rays_per_dispatch=chunk * em.n_rays_once)
    if run_brute:
        check(hits[False] == hits[True], f"city[{n_tri}]: acceleration changed the hit counts "
              f"(front, back): brute {hits[False]}, gated {hits[True]}")
        entry["speedup"] = round(entry["accel"] / entry["brute"], 2)
        if big:
            entry["_calibration"] = {"hits": hits[True][0], "hits_back": hits[True][1],
                                     "brute_rays_per_sec": entry["brute"]}
    else:
        check(hits[True] == (cal["hits"], cal["hits_back"]),
              f"city[{n_tri}]: gated hit checksum (front, back) {hits[True]} != calibrated "
              f"{(cal['hits'], cal['hits_back'])} (run `python3 bench_torch.py --calibrate` "
              "after intended changes)")
        entry["brute"] = cal["brute_rays_per_sec"]
        entry["speedup"] = round(entry["accel"] / entry["brute"], 2)
        entry["brute_anchor"] = "calibrated"
    return entry


def city_curve(dev: torch.device, budget: Budget, *, calibrate: bool = False,
               sizes=CITY_SIZES, extent: float = 100.0, expected_path: Path = EXPECTED_PATH):
    """The occluded-city curve (``bench._city_curve``), each size point
    under the global budget; ``--calibrate`` writes the big points'
    calibrations for this card into ``expected_path``."""
    expected = load_expected(expected_path)
    points, new_cal = {}, {}
    for n_tri in sizes:
        need = (CITY_CALIBRATE_EST_S if calibrate and n_tri >= CALIBRATED_TRIS
                else CITY_EST_S.get(n_tri, 0))
        if budget.remaining() < need:
            note(f"city[{n_tri}] skipped: {budget.remaining():.0f}s left < {need:.0f}s est")
            continue
        t0 = time.monotonic()
        k0 = launches()
        entry = city_point(n_tri, dev, calibrate=calibrate, expected=expected, extent=extent)
        cal = entry.pop("_calibration", None)
        if cal is not None:
            new_cal[str(n_tri)] = cal
        points[str(n_tri)] = entry
        note(f"city[{n_tri}]: {time.monotonic() - t0:.1f}s -> {entry}; launches "
             f"{launches_since(k0)}")
    if calibrate and new_cal:
        expected.setdefault(platform_key(dev), {}).update(new_cal)
        expected_path.write_text(json.dumps(expected, indent=2) + "\n", encoding="utf-8")
        note(f"calibration written to {expected_path.name}: {new_cal}")
    return points or None


def timed_min(label: str, fn, reps: int = 3) -> float:
    """Best-of-``reps`` wall clock (rounded to ms, as ``bench.py``); every
    run is printed unrounded on a note line, since small solves move by up
    to 2x between processes."""
    best = float("inf")
    for rep in range(reps):
        t0 = time.perf_counter()
        fn()
        dt = time.perf_counter() - t0
        note(f"{label} run {rep + 1} of {reps}: {dt:.6f} s")
        best = min(best, dt)
    return round(best, 3)


def district_solve(dev: torch.device) -> float:
    """Warm matrix solve of the 97-emitter district (``bench._district_solve``)."""
    from raystrack_tpu_torch import MatrixParams, PreparedSolver, view_factor_matrix

    meshes = district_meshes()
    ps = PreparedSolver(meshes)
    params = MatrixParams(samples=1, rays=32, seed=7, max_iters=8, min_iters=4, tol=1e-3,
                          reciprocity=True, device=solve_device(dev))
    vf = view_factor_matrix(meshes, params=params, prepared=ps)  # warm
    n_rows = sum(1 for row in vf.values() if row)
    check(n_rows >= 90, f"district solve degenerate: {n_rows} non-empty rows")
    note(f"district: {n_rows} non-empty rows")
    return timed_min("district", lambda: view_factor_matrix(meshes, params=params, prepared=ps))


def plates_meshes():
    """Two parallel unit squares a unit apart, facing each other."""
    def square(name, z, flip):
        V = np.array([[-0.5, -0.5, z], [0.5, -0.5, z], [0.5, 0.5, z], [-0.5, 0.5, z]],
                     np.float32)
        F = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
        return name, V, (F[:, [0, 2, 1]].copy() if flip else F)

    return [square("bottom", 0.0, False), square("top", 1.0, True)]


def canyon_and_plates(dev: torch.device) -> tuple:
    """(the canyon's warm solve seconds, best of 3; the plates' |F - exact|)
    (``bench._canyon_and_plates``)."""
    from examples.ex00_street_canyon_geometry import build_street_canyon
    from raystrack_tpu_torch import MatrixParams, view_factor_matrix

    meshes = build_street_canyon()
    params = MatrixParams(samples=8, rays=512, seed=11, max_iters=60, min_iters=5,
                          device=solve_device(dev))
    view_factor_matrix(meshes, params=params)  # warm
    canyon_s = timed_min("canyon", lambda: view_factor_matrix(meshes, params=params))
    vf = view_factor_matrix(plates_meshes(), params=MatrixParams(
        samples=32, rays=1024, seed=11, tol=1e-4, tol_mode="stderr", min_iters=40,
        max_iters=500, reciprocity=False, device=solve_device(dev)))
    err = abs(vf["bottom"]["top_front"] - PLATES_EXACT)
    note(f"plates: F(bottom -> top_front) {float(vf['bottom']['top_front'])!r}, "
         f"|err| {float(err)!r}")
    return canyon_s, round(err, 8)


def stage(budget: Budget, name: str, est_s: float, fn, failed: list, launch_log: dict,
          default=None):
    """Run one secondary under the budget. Skipped (a note) when less than
    ``est_s`` is left; a stage that raises is noted with its traceback on
    stderr and appended to ``failed``, and ``default`` stands for its
    result. Its launches go to ``launch_log[name]``."""
    if budget.remaining() < est_s:
        note(f"{name} skipped: {budget.remaining():.0f}s left < {est_s:.0f}s est")
        return default
    t0 = time.monotonic()
    k0 = launches()
    try:
        out = fn()
    except Exception as exc:  # the run goes on; main exits 1 after the enriched line
        traceback.print_exc()
        note(f"{name} failed: {type(exc).__name__}: {exc}")
        failed.append(name)
        out = default
    launch_log[name] = launches_since(k0)
    note(f"{name}: {time.monotonic() - t0:.1f}s; launches {launch_log[name]}")
    return out


def card_device():
    """The current CUDA card, or None without one."""
    if not torch.cuda.is_available():
        return None
    return torch.device("cuda", torch.cuda.current_device())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--calibrate", action="store_true",
                    help="run the 1e7 city's brute force live and write its calibration")
    args = ap.parse_args(argv)
    dev = card_device()
    if dev is None:
        print("bench_torch.py needs a CUDA card: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    budget = Budget(float(os.environ.get(BUDGET_VAR, DEFAULT_BUDGET_S)))
    failed, launch_log = [], {}

    t0 = time.monotonic()
    k0 = launches()
    tests_per_sec, rays_per_sec, n_tri_pad, em, times = headline(dev)
    launch_log["headline"] = launches_since(k0)
    result = {
        "metric": "ray_triangle_tests_per_sec",
        "value": round(tests_per_sec),
        "unit": "tests/s",
        "vs_baseline": round(tests_per_sec / BASELINE_TESTS_PER_SEC, 3),
        "rays_per_sec": round(rays_per_sec),
        "n_tri": int(n_tri_pad),
        "rays_per_dispatch": int(CHUNK * em.n_rays_pad),
        "device": card_line(),
    }
    # the headline is on stdout before any secondary can stall; the enriched
    # line is reprinted after every stage
    print(json.dumps(result), flush=True)
    note(f"card: {result['device']}; host cores {os.cpu_count()}; torch {torch.__version__} "
         f"cuda {torch.version.cuda}")
    note(f"headline: {time.monotonic() - t0:.1f}s (incl. the kernels' build at first use); "
         f"dispatches {', '.join(f'{t:.6f}' for t in times)} s; launches "
         f"{launch_log['headline']}")

    result["district_97_emitters_solve_s"] = stage(
        budget, "district", DISTRICT_EST_S, lambda: district_solve(dev), failed, launch_log)
    print(json.dumps(result), flush=True)
    result["occluded_city_rays_per_sec"] = stage(
        budget, "city curve", CITY_EST_S[10_000],
        lambda: city_curve(dev, budget, calibrate=args.calibrate), failed, launch_log)
    print(json.dumps(result), flush=True)
    result["canyon_solve_s"], result["parallel_plates_abs_err"] = stage(
        budget, "canyon+plates", CANYON_PLATES_EST_S, lambda: canyon_and_plates(dev), failed,
        launch_log, default=(None, None))
    result["launches"] = launch_log
    if failed:
        result["failed"] = failed
    print(json.dumps(result), flush=True)
    if failed:
        print(f"bench_torch.py: stages failed: {', '.join(failed)}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
