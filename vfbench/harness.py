"""One run of one cell: the scene, the program's set-up, the measured window
of back-to-back solves, the traced window, the check against the plain
reference, and the result's metrics.

Everything that belongs to one configuration, traffic mix, metric or cell
is a file found by name: ``configs/<config>.json`` (its ``scene`` names
``scenes/<scene>.py``), ``traffic/<traffic>.json``, ``metrics/<metric>.py``
and ``limits/<cell>.json``. The program, ``raystrack_tpu_torch``, is only
called through its public solves and read through its public launch
counters. A cell of ``chips`` cards solves over ``ray_mesh()`` of them.
"""
from __future__ import annotations

import gc
import importlib.util
import json
import sys
import time
import traceback
from dataclasses import dataclass, field
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
SOLVES = ("matrix", "sky", "workflow")
TRACE_SECONDS = 3.0  # a --trace 1 run profiles this much of the start of its window


def _json(path: Path) -> dict:
    with open(path) as fh:
        return json.load(fh)


def _module(path: Path):
    spec = importlib.util.spec_from_file_location(f"vfbench_{path.parent.name}_{path.stem}",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclass
class Cell:
    """A ``workloads`` entry of BENCHMARK.json with its files."""

    name: str
    config: dict
    traffic: dict
    limits: dict
    end_to_end: List[dict]
    per_layer: List[dict]
    chips: int = 1

    @classmethod
    def load(cls, name: str, benchmark: Optional[dict] = None) -> "Cell":
        bench = benchmark if benchmark is not None else _json(ROOT / "BENCHMARK.json")
        work = {w["name"]: w for w in bench["workloads"]}
        if name not in work:
            raise KeyError(f"no workload {name!r} in BENCHMARK.json")
        w = work[name]
        conf = {c["name"]: c for c in bench["configs"]}[w["config"]]
        applies = lambda m: name in m.get("workloads", [name])  # noqa: E731
        return cls(name=name, config=_json(ROOT / conf["file"]),
                   traffic=_json(HERE / "traffic" / f"{w['traffic']}.json"),
                   limits=_json(HERE / "limits" / f"{name}.json"),
                   end_to_end=[m for m in bench["end_to_end"] if applies(m)],
                   per_layer=[m for m in bench["per_layer"] if applies(m)],
                   chips=int(w["chips"]))

    def meshes(self, seed: int):
        scene = _module(HERE / "scenes" / f"{self.config['scene']}.py")
        return scene.build(self.config, seed, **self.traffic.get("scene", {}))


def solve_seed(seed: int, k: int) -> int:
    """QMC seed of solve ``k`` of a run (0 is the warm-up): 31 bits drawn from
    (seed, k), so solves of one run and of different runs draw apart."""
    state = np.random.SeedSequence([seed % (1 << 63), k]).generate_state(1)[0]
    return int(state) & 0x7FFFFFFF


def params(traffic: dict, qmc_seed: int, device: str) -> dict:
    """``{"matrix": fields, "sky": fields}`` of the traffic's solve."""
    kind = traffic["solve"]
    if kind not in SOLVES:
        raise ValueError(f"unknown solve {kind!r}")
    sides = ("matrix", "sky") if kind == "workflow" else (kind,)
    return {s: {**traffic[s], "seed": qmc_seed, "device": device} for s in sides}


def cards(device: str, chips: int) -> List[torch.device]:
    """The devices a cell of ``chips`` solves over: ``cuda:0`` ..
    ``cuda:chips-1`` on the card; on the CPU the CPU ``chips`` times (a
    logical mesh, so the sharded path runs in the CPU tests)."""
    if device == "cpu":
        return [torch.device("cpu")] * chips
    return [torch.device("cuda", i) for i in range(chips)]


def program_solver(traffic: dict, meshes, device: str, chips: int = 1
                   ) -> Callable[[int], object]:
    """The timed entry: one ``PreparedSolver`` and the public solve the
    traffic names, called with a QMC seed. A cell of more than one chip
    passes ``mesh=ray_mesh(cards(device, chips))``; one of one chip passes
    no ``mesh=``."""
    import raystrack_tpu_torch as rt
    import raystrack_tpu_torch.solver as solver

    solver._log = lambda msg: None  # the progress lines' documented hook
    prepared = rt.PreparedSolver(meshes)
    kind = traffic["solve"]
    on_mesh = {}
    if chips > 1:
        from raystrack_tpu_torch.parallel import ray_mesh

        on_mesh["mesh"] = ray_mesh(cards(device, chips))

    def run(qmc_seed: int):
        p = params(traffic, qmc_seed, device)
        if kind == "matrix":
            return rt.view_factor_matrix(meshes, rt.MatrixParams(**p["matrix"]),
                                         prepared=prepared, **on_mesh)
        if kind == "sky":
            return rt.view_factor_to_tregenza_sky(meshes, rt.SkyParams(**p["sky"]),
                                                  prepared=prepared, **on_mesh)
        return rt.view_factor_outside_workflow(
            meshes, matrix_params=rt.MatrixParams(**p["matrix"]),
            sky_params=rt.SkyParams(**p["sky"]), prepared=prepared, **on_mesh)

    return run


def reference_solve(traffic: dict, meshes, qmc_seed: int, device, dtype=torch.float64):
    """The reference's answer to the same solve, shaped as the program's."""
    from vfbench.reference import viewfactor as ref

    p = params(traffic, qmc_seed, "cpu")
    kind = traffic["solve"]
    if kind == "workflow":
        return ref.workflow(meshes, p["matrix"], p["sky"], device=device, dtype=dtype)
    vf, sky = ref.solve(meshes, matrix=p.get("matrix"), sky=p.get("sky"), device=device,
                        dtype=dtype)
    return vf if kind == "matrix" else sky


def widest_gap(program, reference) -> float:
    """The largest |program - reference| over every key of every row of each
    dict (a key missing on one side counts as 0 there)."""
    if isinstance(program, tuple):
        return max(widest_gap(p, r) for p, r in zip(program, reference))
    gap = 0.0
    for row in set(program) | set(reference):
        a, b = program.get(row, {}), reference.get(row, {})
        for key in set(a) | set(b):
            gap = max(gap, abs(float(a.get(key, 0.0)) - float(b.get(key, 0.0))))
    return gap


def launches() -> int:
    """The program's sweep launch counters (kernels #1 and #2)."""
    from raystrack_tpu_torch.ops.trace_cuda import sweep_rays, sweep_rays_scheduled

    return int(sweep_rays.launches) + int(sweep_rays_scheduled.launches)


@dataclass
class Run:
    """What one run measured; the metric readers read it."""

    cell: Cell
    seed: int
    setup_s: float = 0.0
    spans: Dict[str, float] = field(default_factory=dict)
    walls: List[float] = field(default_factory=list)
    window_s: float = 0.0
    peak_bytes_per_card: List[int] = field(default_factory=list)
    trace: object = None
    failed: int = 0
    checked: int = 0
    checks: Dict[str, dict] = field(default_factory=dict)

    @property
    def peak_bytes(self) -> int:
        """The fullest card's peak memory."""
        return max(self.peak_bytes_per_card, default=0)

    @property
    def correct(self) -> bool:
        return (self.failed == 0 and bool(self.checks)
                and all(c["value"] <= c["limit"] for c in self.checks.values()))


def _span(run: Run, name: str, fn):
    from torch.profiler import record_function

    t0 = time.perf_counter()
    with record_function(f"vfbench.{name}"):
        out = fn()
    run.spans[name] = run.spans.get(name, 0.0) + time.perf_counter() - t0
    return out


def measure(cell: Cell, seed: int, seconds: float, *, trace: bool, t_start: float,
            device: str = "gpu") -> Run:
    """Set up, warm up, solve back to back for ``seconds`` (traced for the
    first ``TRACE_SECONDS`` with ``trace``), then check a sample of the
    window's solves against the reference. On the card every card of the
    cell is synchronised after each solve and its peak memory read."""
    on_card = device == "gpu"
    run = Run(cell=cell, seed=seed)
    used = cards(device, cell.chips) if on_card else []
    if on_card:
        torch.cuda.init()  # a card's memory statistics exist once CUDA has started
    for d in used:
        torch.cuda.reset_peak_memory_stats(d)
    meshes = _span(run, "scene", lambda: cell.meshes(seed))
    solve = _span(run, "prepare",
                  lambda: program_solver(cell.traffic, meshes, device, cell.chips))
    _span(run, "warmup", lambda: solve(solve_seed(seed, 0)))

    def sync():
        for d in used:
            torch.cuda.synchronize(d)

    sync()
    run.setup_s = time.perf_counter() - t_start

    outputs, seeds = [], []
    k = 0

    def one():
        nonlocal k
        k += 1
        s = solve_seed(seed, k)
        t = time.perf_counter()
        try:
            out = solve(s)
        except Exception as exc:  # a solve that raises fails; the window goes on
            traceback.print_exc(file=sys.stderr)
            run.failed += 1
            out = exc
        sync()
        run.walls.append(time.perf_counter() - t)
        outputs.append(out)
        seeds.append(s)

    if trace:
        from vfbench import tracing

        before = launches()
        with tracing.profiled(cell.chips) as got:
            t0 = time.perf_counter()  # the profiler's start-up stays outside the window
            while time.perf_counter() - t0 < TRACE_SECONDS:
                _span(run, "solve", one)
        run.trace = got[0]
        run.trace.solves = len(run.walls)
        run.trace.launches = launches() - before
    else:
        t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        one()
    run.window_s = time.perf_counter() - t0
    run.peak_bytes_per_card = [int(torch.cuda.max_memory_allocated(d)) for d in used]

    del solve
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    check(run, meshes, outputs, seeds, "cuda" if on_card else "cpu")
    return run


def check(run: Run, meshes, outputs, seeds, device) -> None:
    """The widest gap between the program's answer and the reference's over
    a sample of the window's solves drawn from the seed: the longest solve
    and ``check_solves - 1`` others."""
    traffic = run.cell.traffic
    done = [i for i, out in enumerate(outputs) if not isinstance(out, Exception)]
    if not done:
        return
    longest = max(done, key=lambda i: run.walls[i])
    rng = np.random.default_rng(run.seed % (1 << 63))
    others = [i for i in done if i != longest]
    n = min(len(others), int(traffic.get("check_solves", 1)) - 1)
    sample = [longest] + [int(i) for i in rng.choice(others, size=n, replace=False)]
    gap = 0.0
    for i in sample:
        want = reference_solve(traffic, meshes, seeds[i], device)
        gap = max(gap, widest_gap(outputs[i], want))
    run.checks["gap"] = {"value": gap, "limit": float(run.cell.limits["gap"])}
    run.checked = len(sample)


def metric_values(run: Run, trace: bool) -> Dict[str, dict]:
    """The cell's end-to-end metrics (``trace`` false) or per-layer metrics,
    each read by ``metrics/<name>.py``; a reader that finds nothing returns
    None and the metric is left out."""
    out = {}
    for m in (run.cell.per_layer if trace else run.cell.end_to_end):
        value = _module(HERE / "metrics" / f"{m['name']}.py").read(run)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result(run: Run, trace: bool) -> dict:
    """The run's result line."""
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": run.cell.chips, "memory_peak_bytes": run.peak_bytes,
              "memory_peak_bytes_per_card": run.peak_bytes_per_card}
    line = {"correct": run.correct, "attempted": len(run.walls), "failed": run.failed,
            "metrics": metric_values(run, trace), "device": device}
    if trace and run.trace is not None:
        device["busy_s"] = run.trace.busy_s
        device["window_s"] = run.trace.window_s
        line["breakdown"] = run.trace.breakdown()
    line["checks"] = run.checks
    return line
