#!/usr/bin/env python3
"""Head-to-head on one NVIDIA card: the port's gated sweep against the
reference engine's BVH path on the host's cores, the PyTorch / CUDA port's
counterpart of ``benchmarks/head_to_head.py``.

The reference's accelerated path is a numba median-split BVH traversal on
CPU cores. The baseline is ``benchmarks/ref_bvh_baseline.cpp``, the same
algorithm (median split on the longest centroid axis, leaf 8,
near-child-first stack traversal pruned by the running nearest hit,
Möller–Trumbore with the reference's epsilons) compiled with g++ -O3
-ffast-math into ``build/head_to_head/`` and threaded over the host's cores.

Equal work, equal accounting:

- both engines trace the identical ray set. The card generates it
  (``ops.trace.generate_rays``, the same seed, Cranley-Patterson rows and
  Halton tables as the timed dispatch) and the C++ binary gets those exact
  rays: the card's raygen differs from a CPU raygen by ulps. The card side
  times ``bench_torch.run_chunk``'s fused gated dispatch (raygen, coherence
  sort, gate tables, kernel #1 gated, the count kernel); raygen is free for
  the baseline;
- the hit checksum (nearest hits, front and back, on receiver surfaces) is
  computed by both engines; a relative difference of 1e-3 or more fails
  the run.

Rays are reported both ways: padded (``n_rays_pad``, as ``bench_torch.py``
counts them) and valid (``n_rays_once``, the rays the baseline traces);
the ratios use valid rays on both sides.

Writes ``docs/measurements/head_to_head_torch.json`` (the card's name and
power limit, the host's core count) and prints a markdown table. Needs a
CUDA card and g++: without a card it exits 2 and says so. Imports nothing
of JAX.

Usage: python3 head_to_head_torch.py [--sizes 10000,100000,...]
       [--threads N] (default: every host core) [--seed S] [--out FILE]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

from bench_torch import card_device, force, launches, launches_since, run_chunk, timed_runs
from city_100m_torch import card_line, city_meshes

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "benchmarks" / "ref_bvh_baseline.cpp"
BUILD_DIR = ROOT / "build" / "head_to_head"
OUT_PATH = ROOT / "docs" / "measurements" / "head_to_head_torch.json"
CXX_FLAGS = ("-O3", "-march=native", "-ffast-math", "-funroll-loops", "-std=c++17",
             "-pthread")
MAX_REL_DIFF = 1e-3  # edge rays may flip between the two float formulations


def ensure_binary(build_dir: Path = BUILD_DIR) -> Path:
    """The baseline binary, built from ``benchmarks/ref_bvh_baseline.cpp``
    with ``benchmarks/head_to_head.py``'s g++ flags into ``build_dir``
    (rebuilt when the source is newer)."""
    binary = build_dir / "ref_bvh_baseline"
    if binary.exists() and binary.stat().st_mtime >= SRC.stat().st_mtime:
        return binary
    build_dir.mkdir(parents=True, exist_ok=True)
    subprocess.run(["g++", *CXX_FLAGS, "-o", str(binary), str(SRC)], check=True)
    return binary


def materialize_rays(em, chunk: int, seed: int, dev: torch.device) -> tuple:
    """The valid rays the card's dispatch of this seed and chunk traces:
    ``generate_rays`` on ``em``'s tables on ``dev``, iterations in order,
    each cut to its ``n_rays_once`` real rays; (origins, directions) as
    (chunk * n_rays_once, 3) float32 host arrays."""
    from raystrack_tpu_torch.ops.trace import generate_rays
    from raystrack_tpu_torch.solver import _cp_rows, _emission_geometry, _ray_tables

    cp = torch.from_numpy(_cp_rows(seed, 0, 0, chunk)).to(dev)
    o, d = generate_rays(_ray_tables(em), _emission_geometry(em), cp)
    return tuple(np.ascontiguousarray(t[:, : em.n_rays_once].reshape(-1, 3).cpu().numpy(),
                                      dtype=np.float32) for t in (o, d))


def scene_arrays(meshes) -> tuple:
    """Raw triangle arrays (reference layout: v0/e1/e2/norm/sid)."""
    v0s, e1s, e2s, sids = [], [], [], []
    for s, (_, V, F) in enumerate(meshes):
        a = V[F[:, 0]].astype(np.float32)
        b = V[F[:, 1]].astype(np.float32)
        c = V[F[:, 2]].astype(np.float32)
        v0s.append(a)
        e1s.append(b - a)
        e2s.append(c - a)
        sids.append(np.full(len(F), s, np.int32))
    v0 = np.concatenate(v0s)
    e1 = np.concatenate(e1s)
    e2 = np.concatenate(e2s)
    norm = np.cross(e1, e2).astype(np.float32)
    return v0, e1, e2, norm, np.concatenate(sids)


def write_scene_bin(path: Path, meshes, orig, dirs, surf_active, emit_sid: int,
                    min_sid: int) -> int:
    """The baseline's input file (the byte format ``ref_bvh_baseline.cpp``
    reads); returns the triangle count."""
    v0, e1, e2, norm, sid = scene_arrays(meshes)
    with open(path, "wb") as f:
        np.int64(len(sid)).tofile(f)
        np.int64(len(orig)).tofile(f)
        np.int32(len(surf_active)).tofile(f)
        np.int32(emit_sid).tofile(f)
        np.int32(min_sid).tofile(f)
        np.asarray(surf_active, np.int32).tofile(f)
        v0.tofile(f)
        e1.tofile(f)
        e2.tofile(f)
        norm.tofile(f)
        sid.tofile(f)
        np.ascontiguousarray(orig).tofile(f)
        np.ascontiguousarray(dirs).tofile(f)
    return len(sid)


def gpu_point(ps, dev: torch.device, chunk: int, rays: int, reps: int, seed: int):
    """The fused gated dispatch's rays/s (best of ``reps``, padded and
    valid) and its hit checksum, all nearest hits (front + back): the city's
    box faces mostly show their backs to ground rays, so front hits alone
    are a near-empty check; the launches of the port's kernels it made.
    Returns (the point, the emitter pack)."""
    k0 = launches()
    run = lambda s: run_chunk(ps, dev, accel=True, seed=s, chunk=chunk,  # noqa: E731
                              samples=1, rays=rays)
    out, em, _ = run(seed)
    hits = force(out) + int(out["counts_b"].cpu().numpy().sum())
    times = timed_runs(run, range(seed + 1, seed + 1 + reps))
    best = min(times)
    return {
        "rays_per_sec": round(chunk * em.n_rays_pad / best),
        "rays_per_sec_valid": round(chunk * em.n_rays_once / best),
        "hits": hits,
        "n_rays_valid": chunk * em.n_rays_once,
        "n_rays_padded": chunk * em.n_rays_pad,
        "pad_frac": round(1 - em.n_rays_once / em.n_rays_pad, 4),
        "dispatch_s": times,
        "launches": launches_since(k0),
    }, em


def baseline_point(binary: Path, meshes, orig, dirs, threads: int, reps: int,
                   work_dir: Path) -> dict:
    """The C++ engine on these rays (every surface but sid 0 a receiver):
    its JSON line, with the wall of the whole run (BVH build included)."""
    surf_active = np.zeros(len(meshes), np.int32)
    surf_active[1:] = 1  # bench convention: all but the emitter receive
    work_dir.mkdir(parents=True, exist_ok=True)
    scene_path = work_dir / f"scene_{os.getpid()}.bin"
    try:
        write_scene_bin(scene_path, meshes, orig, dirs, surf_active, emit_sid=0, min_sid=0)
        t0 = time.monotonic()
        proc = subprocess.run([str(binary), str(scene_path), str(threads), str(reps)],
                              capture_output=True, text=True, check=True)
        ref = json.loads(proc.stdout.strip())
        ref["wall_s"] = round(time.monotonic() - t0, 1)
    finally:
        scene_path.unlink(missing_ok=True)
    return ref


def compare(n_tri: int, gpu: dict, ref: dict) -> dict:
    """One size's row; raises when the two checksums differ by 1e-3 or more."""
    ref_hits = ref["hits_front"] + ref["hits_back"]
    diff = abs(ref_hits - gpu["hits"])
    rel = diff / max(gpu["hits"], 1)
    if not rel < MAX_REL_DIFF:
        raise RuntimeError(f"hit accounting diverged at {n_tri}: card {gpu['hits']} "
                           f"C++ {ref_hits} (relative {rel})")
    per_core = ref["rays_per_sec"] / ref["threads"]
    return {
        "gpu_rays_per_sec": gpu["rays_per_sec"],
        "gpu_rays_per_sec_valid": gpu["rays_per_sec_valid"],
        "gpu_dispatch_s": gpu["dispatch_s"],
        "gpu_launches": gpu["launches"],
        "ref_bvh_rays_per_sec": round(ref["rays_per_sec"]),
        "ref_bvh_rays_per_sec_per_core": round(per_core),
        "ref_threads": ref["threads"],
        "ref_build_s": ref["build_s"],
        "ref_trace_s": ref["trace_s"],
        "ref_wall_s": ref["wall_s"],
        "hits_gpu": gpu["hits"],
        "hits_ref": ref_hits,
        "hits_abs_diff": diff,
        "hits_rel_diff": rel,
        "n_rays": gpu["n_rays_valid"],
        "n_rays_padded": gpu["n_rays_padded"],
        "pad_frac": gpu["pad_frac"],
        "gpu_vs_ref_per_core": round(gpu["rays_per_sec_valid"] / per_core, 2),
        "gpu_vs_ref_total": round(gpu["rays_per_sec_valid"] / ref["rays_per_sec"], 2),
    }


def run(sizes, dev: torch.device, *, threads: int, seed: int = 0,
        binary: Path = None, work_dir: Path = BUILD_DIR, extent: float = 100.0) -> dict:
    """Every size's row, as ``benchmarks/head_to_head.py`` measures it:
    chunk 2, 2 rays a cell, 3 reps below 1e7 triangles; 1, 1 and 2 from
    there."""
    from raystrack_tpu_torch import PreparedSolver

    binary = binary or ensure_binary()
    points = {}
    for n_tri in sizes:
        big = n_tri >= 10_000_000
        chunk, rays, reps = (1, 1, 2) if big else (2, 2, 3)
        t0 = time.monotonic()
        meshes = city_meshes(n_tri, extent)
        ps = PreparedSolver(meshes)
        gpu, em = gpu_point(ps, dev, chunk, rays, reps, seed)
        orig, dirs = materialize_rays(em, chunk, seed, dev)
        if len(orig) != gpu["n_rays_valid"]:
            raise RuntimeError(f"{len(orig)} rays materialized, {gpu['n_rays_valid']} traced")
        del ps, em
        ref = baseline_point(binary, meshes, orig, dirs, threads, reps, work_dir)
        point = compare(n_tri, gpu, ref)
        point["point_wall_s"] = round(time.monotonic() - t0, 1)
        points[str(n_tri)] = point
        print(f"# {n_tri}: {json.dumps(point)}", flush=True)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return points


def table(points: dict, threads: int) -> str:
    lines = ["| triangles | card gated sweep (valid rays/s) | ref BVH total (rays/s) "
             f"| ref BVH per core | card / ref core | card / ref total ({threads} threads) "
             "| hits card / C++ (rel. diff) |",
             "|---|---|---|---|---|---|---|"]
    for n, p in points.items():
        lines.append(f"| {int(n):,} | {p['gpu_rays_per_sec_valid']:,} "
                     f"| {p['ref_bvh_rays_per_sec']:,} | {p['ref_bvh_rays_per_sec_per_core']:,} "
                     f"| {p['gpu_vs_ref_per_core']}x | {p['gpu_vs_ref_total']}x "
                     f"| {p['hits_gpu']:,} / {p['hits_ref']:,} ({p['hits_rel_diff']:.3g}) |")
    return "\n".join(lines)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--sizes", default="10000,100000,1000000,10000000")
    ap.add_argument("--threads", type=int, default=0,
                    help="baseline threads (0 = every host core)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--out", type=Path, default=OUT_PATH,
                    help="results file (default docs/measurements/head_to_head_torch.json)")
    args = ap.parse_args(argv)
    dev = card_device()
    if dev is None:
        print("head_to_head_torch.py needs a CUDA card: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 2
    sizes = [int(s) for s in args.sizes.split(",")]
    cores = os.cpu_count() or 1
    threads = args.threads or cores
    card = card_line()
    print(f"# card: {card}; host cores {cores}; baseline threads {threads}; torch "
          f"{torch.__version__} cuda {torch.version.cuda}", flush=True)
    points = run(sizes, dev, threads=threads, seed=args.seed)
    results = {"device": card, "device_name": torch.cuda.get_device_name(dev),
               "host_cores": cores, "baseline_threads": threads,
               "baseline_flags": " ".join(CXX_FLAGS), "seed": args.seed, "points": points}
    args.out.parent.mkdir(parents=True, exist_ok=True)
    args.out.write_text(json.dumps(results, indent=2) + "\n", encoding="utf-8")
    print(f"# written: {args.out}")
    print(table(points, threads))
    return 0


if __name__ == "__main__":
    sys.exit(main())
