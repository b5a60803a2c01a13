#!/usr/bin/env python3
"""Validation cases 01-09 of ``validation/`` through the PyTorch port.

Run from the repository root:

    python3 validate_torch.py                  # on the CUDA card (the default)
    python3 validate_torch.py --device cpu     # on the CPU (slow at full settings)
    python3 validate_torch.py --cases 01,07    # some cases only
    python3 validate_torch.py --reduced        # few iterations: a quick run, not a validation

Each case runs ``raystrack_tpu_torch`` at the settings its
``validation/validate_0N_*.py`` states (samples, rays, seed, tolerance and
its mode, iterations; cases 01-06 and 09 with the fixed execution set-up of
``validation/common.run_solver``: ``bvh="builtin"``, a convergence check
every iteration, raw rows without reciprocity). Per case it prints the
port's value, the analytic (case 09: View3D) value, |err|, the case's own
tolerance, the iterations scraped from the solver's progress lines and the
result, and beside them the committed TPU value and iterations from
``validation/results/`` with the difference. A difference from the
committed numbers is reported, not judged. Then the card's name and power
limit. Writes ``results.json`` into ``--out`` (default
``build/validate_torch``, which git ignores) and nothing else; exits 1 if
any case fails its own tolerance, 2 if ``--device gpu`` finds no card.

Imports nothing of JAX or of the JAX package: only ``validation/analytic.py``,
the NumPy helpers of ``validation/common.py``,
``examples/ex00_street_canyon_geometry.py`` and the port's copy of ex04's
cube, ``examples_torch/ex04_inside_enclosure.py``.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np

ROOT = Path(__file__).resolve().parent
RESULTS = ROOT / "validation" / "results"
VIEW3D_RAW = ROOT / "validation" / "view3d_reference" / "canyon_view3d_raw.json"
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from examples.ex00_street_canyon_geometry import build_street_canyon  # noqa: E402
from examples_torch.ex04_inside_enclosure import make_box_unit_cube  # noqa: E402
from validation import analytic  # noqa: E402
from validation.common import (  # noqa: E402
    aggregate_per_face_rows, base_matrix, disk_xy, max_abs_pair_diff, rectangle_xy,
    rectangle_yz, row_front_to,
)

# validation/common.py's pinned configuration and run_solver's fixed execution set-up
PINNED = dict(seed=11, tol=1.0e-4, tol_mode="stderr", min_iters=40)
FIXED = dict(bvh="builtin", convergence_interval=1, reciprocity=False,
             enforce_reciprocity_rowsum=False, flip_faces=False)

# --reduced: few iterations everywhere, and the canyon's cases at one sample
# per m² (their full grids are 2M rays an iteration, slow on a CPU)
REDUCED = dict(min_iters=3, max_iters=3)
REDUCED_CANYON = dict(REDUCED, samples=1, rays=256)

_ITER_LINE = re.compile(r"\[\s*(?P<name>[^\]]+?)\s*\]\s+(?P<iters>\d+)\s+iter")


@dataclasses.dataclass
class Run:
    """One solve of a case: what the JAX package would be given, and the rows."""

    kind: str  # "matrix" or "sky"
    meshes: list
    params: dict
    vf: Dict[str, Dict[str, float]]
    iterations: Dict[str, int]


@dataclasses.dataclass
class CaseResult:
    case: str
    quantity: str  # what ``value`` is
    value: float
    reference: float  # the analytic value (case 09: View3D's)
    err: float  # the case's measure, held to ``tol``
    tol: float
    passed: bool
    runs: List[Run]
    extra: Dict[str, object] = dataclasses.field(default_factory=dict)
    # the port's value of the committed file's quantity (at its pair, for 06 and 09)
    value_as_committed: Optional[float] = None

    @property
    def iterations(self) -> Dict[str, int]:
        return self.runs[0].iterations


def _solve(kind: str, meshes, params: dict) -> Run:
    """Solve through the port, scraping per-emitter iterations from its
    progress lines as ``validation/common.run_solver`` does."""
    import raystrack_tpu_torch as rt
    import raystrack_tpu_torch.solver as solver_mod

    lines: List[str] = []
    previous = solver_mod._log
    solver_mod._log = lines.append
    try:
        if kind == "matrix":
            vf = rt.view_factor_matrix(meshes, params=rt.MatrixParams(**params))
        else:
            vf = rt.view_factor_to_tregenza_sky(meshes, params=rt.SkyParams(**params))
    finally:
        solver_mod._log = previous
    iterations: Dict[str, int] = {}
    for line in lines:
        hit = _ITER_LINE.search(line)
        if hit:
            iterations[hit.group("name")] = int(hit.group("iters"))
    return Run(kind, meshes, params, vf, iterations)


def _matrix_params(device, overrides, *, samples, rays, seed=PINNED["seed"], max_iters=500,
                   min_iters=40) -> dict:
    """``common.run_solver``'s configuration."""
    params = dict(PINNED, samples=samples, rays=rays, seed=seed, min_iters=min_iters,
                  max_iters=max_iters, device=device, **FIXED)
    params.update(overrides)
    return params


def _pair_case(case, quantity, meshes, emitter, receiver, analytical, *, samples, rays,
               device, overrides) -> CaseResult:
    run = _solve("matrix", meshes, _matrix_params(device, overrides, samples=samples,
                                                  rays=rays))
    value = row_front_to(run.vf[emitter], receiver)
    err = abs(value - analytical)
    return CaseResult(case, quantity, value, analytical, err, 1.0e-4, err <= 1.0e-4, [run],
                      value_as_committed=value)


def case_01(device, overrides) -> CaseResult:
    W, H = 1.0, 1.0
    meshes = [rectangle_xy("plate_1", W, W, 0.0, normal=+1),
              rectangle_xy("plate_2", W, W, H, normal=-1)]
    return _pair_case("01_parallel_equal_square", "F(plate_1 -> plate_2)", meshes, "plate_1",
                      "plate_2", analytic.equal_parallel_squares(W, H), samples=32, rays=1024,
                      device=device, overrides=overrides)


def case_02(device, overrides) -> CaseResult:
    W1, W2, H = 2.0, 1.0, 1.0
    meshes = [rectangle_xy("plate_1", W1, W2, 0.0, normal=+1),
              rectangle_xy("plate_2", W1, W2, H, normal=-1)]
    return _pair_case("02_parallel_equal_rectangle", "F(plate_1 -> plate_2)", meshes,
                      "plate_1", "plate_2", analytic.equal_parallel_rectangles(W1, W2, H),
                      samples=16, rays=512, device=device, overrides=overrides)


def case_03(device, overrides) -> CaseResult:
    R, H = 1.0, 1.0
    meshes = [disk_xy("disc_1", R, 0.0, segments=256, normal=+1),
              disk_xy("disc_2", R, H, segments=256, normal=-1)]
    return _pair_case("03_equal_coaxial_discs", "F(disc_1 -> disc_2)", meshes, "disc_1",
                      "disc_2", analytic.equal_coaxial_discs(R, H), samples=16, rays=512,
                      device=device, overrides=overrides)


def case_04(device, overrides) -> CaseResult:
    R, H = 1.0, 1.0
    meshes = [rectangle_xy("patch", 0.04, 0.04, 0.0, normal=+1),
              disk_xy("disc", R, H, segments=256, normal=-1)]
    return _pair_case("04_patch_to_disc", "F(patch -> disc)", meshes, "patch", "disc",
                      analytic.patch_to_disc(R, H), samples=8, rays=1024, device=device,
                      overrides=overrides)


def case_05(device, overrides) -> CaseResult:
    W, H = 1.0, 1.0
    meshes = [rectangle_xy("square", W, W, 0.0, normal=+1, center=(W / 2.0, 0.0)),
              rectangle_yz("adjacent_rectangle", W, H, 0.0, normal=+1, y_center=0.0,
                           z_min=0.0)]
    return _pair_case("05_perpendicular_square_rectangle", "F(square -> adjacent_rectangle)",
                      meshes, "square", "adjacent_rectangle",
                      analytic.square_to_adjacent_rectangle(H, W), samples=32, rays=512,
                      device=device, overrides=overrides)


def _canyon_case(case, reference, reference_name, device, overrides) -> CaseResult:
    meshes = build_street_canyon()
    names = [name for name, _, _ in meshes]
    run = _solve("matrix", meshes, _matrix_params(device, overrides, samples=8, rays=512,
                                                  seed=31))
    solver_base = base_matrix(run.vf)
    diff, (sender, receiver), got, want = max_abs_pair_diff(solver_base, reference,
                                                             names=names)
    committed = read_committed(case)
    c_sender, c_receiver = committed.get("pair", (sender, receiver))
    return CaseResult(
        case, f"F({sender} -> {receiver}), the worst pair", got, want, diff, 1.0e-4,
        diff <= 1.0e-4, [run],
        extra={"worst_pair": f"{sender} -> {receiver}", "reference": reference_name},
        value_as_committed=float(solver_base.get(c_sender, {}).get(c_receiver, 0.0)))


def case_06(device, overrides) -> CaseResult:
    return _canyon_case("06_canyon_analytic", analytic.canyon_ground_truth(), "analytic",
                        device, overrides)


def case_09(device, overrides) -> CaseResult:
    meshes = build_street_canyon()
    raw = json.loads(VIEW3D_RAW.read_text(encoding="utf-8"))
    view3d = aggregate_per_face_rows(raw, meshes)
    a_diff = max_abs_pair_diff(analytic.canyon_ground_truth(), view3d,
                               names=[name for name, _, _ in meshes])[0]
    result = _canyon_case("09_canyon_view3d", view3d, "View3D", device, overrides)
    # the case's first assertion: the analytic matrix agrees with View3D
    result.extra["analytic_vs_view3d"] = a_diff
    result.passed = result.passed and a_diff <= 5.0e-6
    return result


def case_07(device, overrides) -> CaseResult:
    meshes = build_street_canyon()
    truth = analytic.canyon_ground_truth()
    sky_analytic = 1.0 - sum(truth["road"].values())
    base = dict(samples=8, rays=512, seed=17, bvh="builtin", device=device, tol=1e-4,
                tol_mode="stderr", min_iters=40, max_iters=500)
    base.update(overrides)
    merged = _solve("sky", meshes, base)
    discrete = _solve("sky", meshes, dict(base, discrete=True))
    got = merged.vf["road"]["Sky"]
    patch_diff = abs(sum(discrete.vf["road"].values()) - got)
    diff = abs(got - sky_analytic)
    return CaseResult("07_canyon_sky", "merged Sky of the road", got, sky_analytic, diff,
                      1.0e-4, diff <= 1.0e-4 and patch_diff <= 1.0e-4, [merged, discrete],
                      extra={"patch_vs_merged": patch_diff}, value_as_committed=got)


OPPOSITE = {"Bottom": "Top", "Top": "Bottom", "Front": "Back",
            "Back": "Front", "Left": "Right", "Right": "Left"}


def case_08(device, overrides) -> CaseResult:
    meshes = make_box_unit_cube()
    params = dict(samples=32, rays=512, seed=23, bvh="builtin", device=device,
                  flip_faces=True, reciprocity=False, tol=5e-5, tol_mode="stderr",
                  min_iters=40, max_iters=4000)
    params.update(overrides)
    run = _solve("matrix", meshes, params)
    want_opp = analytic.equal_parallel_squares(1.0, 1.0)
    want_adj = analytic.square_to_adjacent_rectangle(1.0, 1.0)
    max_opp = max_adj = worst_row = 0.0
    for name, _, _ in meshes:
        row = run.vf[name]
        total = {k[:-5] if k.endswith("_back") else k[:-6]: v for k, v in row.items()}
        max_opp = max(max_opp, abs(total.get(OPPOSITE[name], 0.0) - want_opp))
        for other, _, _ in meshes:
            if other not in (name, OPPOSITE[name]):
                max_adj = max(max_adj, abs(total.get(other, 0.0) - want_adj))
        worst_row = max(worst_row, abs(sum(row.values()) - 1.0))
    tol, row_tol = 1.5e-4, 5.0e-3  # 3 sigma of the 5e-5 stderr target; seam escapes
    err = max(max_opp, max_adj)
    return CaseResult(
        "08_cube_interior", "max |F - closed form| over the 30 pairs", err, 0.0, err, tol,
        max_opp <= tol and max_adj <= tol and worst_row <= row_tol, [run],
        extra={"max_abs_diff_opposite": max_opp, "max_abs_diff_adjacent": max_adj,
               "max_rowsum_defect": worst_row, "rowsum_tolerance": row_tol},
        value_as_committed=err)


CASES: Dict[str, Callable] = {
    "01": case_01, "02": case_02, "03": case_03, "04": case_04, "05": case_05,
    "06": case_06, "07": case_07, "08": case_08, "09": case_09,
}
CANYON_CASES = ("06", "07", "09")


def reduced_overrides(case_id: str) -> dict:
    return dict(REDUCED_CANYON if case_id in CANYON_CASES else REDUCED)


# ---------------------------------------------------------------------------
# The committed TPU results
# ---------------------------------------------------------------------------


def _parse_result_file(text: str) -> Dict[str, object]:
    """``key: value`` lines of a committed result file, an indented block's
    keys prefixed by its title (``solver_vs_view3d.max_abs_diff``), and the
    per-emitter ``iterations`` block as a dict."""
    fields: Dict[str, object] = {}
    iterations: Dict[str, int] = {}
    section, in_iters = "", False
    for line in text.splitlines():
        if not line.strip():
            section, in_iters = "", False
            continue
        key, _, value = line.strip().partition(":")
        value = value.strip()
        indent = len(line) - len(line.lstrip())
        if in_iters and indent >= 4:
            iterations[key] = int(value)
            continue
        in_iters = key == "iterations"
        if not value:
            section = key if indent == 0 else section
            continue
        fields[f"{section}.{key}" if indent and section not in ("", "settings", "convergence")
               else key] = value
    fields["iterations"] = iterations
    return fields


# per case: the committed file's value, its |err| and, for 06 and 09, its pair
_COMMITTED_KEYS = {
    "01_parallel_equal_square": ("raystrack_tpu", "abs_diff", None),
    "02_parallel_equal_rectangle": ("raystrack_tpu", "abs_diff", None),
    "03_equal_coaxial_discs": ("raystrack_tpu", "abs_diff", None),
    "04_patch_to_disc": ("raystrack_tpu", "abs_diff", None),
    "05_perpendicular_square_rectangle": ("raystrack_tpu", "abs_diff", None),
    "06_canyon_analytic": ("solver", "max_abs_diff", "at_pair"),
    "07_canyon_sky": ("merged_sky", "abs_diff", None),
    "08_cube_interior": (None, None, None),
    "09_canyon_view3d": ("solver_vs_view3d.solver", "solver_vs_view3d.max_abs_diff",
                         "solver_vs_view3d.at_pair"),
}


def read_committed(case: str) -> Dict[str, object]:
    """The committed TPU run of ``case`` from ``validation/results/``:
    ``value`` (the same quantity as ``CaseResult.value_as_committed``),
    ``err``, ``passed``, ``iterations`` and, for 06 and 09, ``pair``."""
    fields = _parse_result_file((RESULTS / f"{case}.txt").read_text(encoding="utf-8"))
    value_key, err_key, pair_key = _COMMITTED_KEYS[case]
    if value_key is None:  # 08: the case's measure is the larger of two max errors
        err = max(float(fields["max_abs_diff_opposite"]), float(fields["max_abs_diff_adjacent"]))
        value = err
    else:
        value, err = float(fields[value_key]), float(fields[err_key])
    passed = [v == "True" for k, v in fields.items() if k.split(".")[-1] == "passed"]
    out = {"value": value, "err": err, "iterations": fields["iterations"],
           "passed": bool(passed) and all(passed)}
    if pair_key is not None:
        out["pair"] = tuple(s.strip() for s in str(fields[pair_key]).split("->"))
    return out


# ---------------------------------------------------------------------------
# Running the cases
# ---------------------------------------------------------------------------


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of the card(s)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60)
        return out.stdout.strip() or f"nvidia-smi: {out.stderr.strip()}"
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi: not available ({exc})"


def _iters_text(iterations: Dict[str, int]) -> str:
    if not iterations:
        return "-"
    values = list(iterations.values())
    return f"{min(values)}-{max(values)}" if min(values) != max(values) else str(values[0])


def format_result(r: CaseResult, committed: Dict[str, object]) -> str:
    diff = r.value_as_committed - committed["value"]
    line = (f"{r.case}: {r.quantity} = {r.value:.10f}, reference {r.reference:.10f}, "
            f"|err| {r.err:.4e} (tol {r.tol:.1e}), iters {_iters_text(r.iterations)}: "
            f"{'PASS' if r.passed else 'FAIL'} | committed TPU {committed['value']:.10f} "
            f"(|err| {committed['err']:.4e}, iters {_iters_text(committed['iterations'])})")
    if "pair" in committed:
        line += f" at {' -> '.join(committed['pair'])}, the port there {r.value_as_committed:.10f}"
    line += f", difference {diff:+.4e}"
    if r.extra:
        line += " | " + ", ".join(
            f"{k} {v:.4e}" if isinstance(v, float) else f"{k} {v}" for k, v in r.extra.items())
    return line


def run_cases(case_ids, device: str, *, reduced: bool = False, log=print) -> List[CaseResult]:
    results = []
    for case_id in case_ids:
        t0 = time.perf_counter()
        result = CASES[case_id](device, reduced_overrides(case_id) if reduced else {})
        result.extra["seconds"] = time.perf_counter() - t0
        log(format_result(result, read_committed(result.case)))
        results.append(result)
    return results


def to_json(results: List[CaseResult], device: str, card: str, reduced: bool) -> dict:
    return {"device": device, "card": card, "reduced": reduced, "cases": [
        {"case": r.case, "quantity": r.quantity, "value": r.value, "reference": r.reference,
         "err": r.err, "tol": r.tol, "passed": r.passed,
         "iterations": [run.iterations for run in r.runs],
         "params": [run.params for run in r.runs], "extra": r.extra,
         "value_as_committed": r.value_as_committed, "committed": read_committed(r.case),
         "rows": [run.vf for run in r.runs]}
        for r in results]}


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--device", choices=("gpu", "cpu"), default="gpu")
    parser.add_argument("--cases", default=",".join(CASES),
                        help="comma-separated case numbers (default: all nine)")
    parser.add_argument("--reduced", action="store_true",
                        help=f"{REDUCED} ({REDUCED_CANYON} for cases "
                             f"{', '.join(CANYON_CASES)}): a quick run, not a validation")
    parser.add_argument("--out", type=Path, default=ROOT / "build" / "validate_torch")
    args = parser.parse_args(argv)
    case_ids = [c.strip().zfill(2) for c in args.cases.split(",") if c.strip()]
    unknown = sorted(set(case_ids) - set(CASES))
    if unknown:
        parser.error(f"unknown cases {unknown}; known: {sorted(CASES)}")

    import torch

    if args.device == "gpu" and not torch.cuda.is_available():
        print("validate_torch.py --device gpu needs a CUDA card: "
              "torch.cuda.is_available() is false (pass --device cpu)", file=sys.stderr)
        return 2
    card = card_line() if args.device == "gpu" else "cpu"
    t0 = time.perf_counter()
    results = run_cases(case_ids, args.device, reduced=args.reduced)
    n_failed = sum(not r.passed for r in results)
    print(f"{len(results) - n_failed}/{len(results)} cases within their own tolerances "
          f"on {args.device}{' (reduced settings)' if args.reduced else ''} in "
          f"{time.perf_counter() - t0:.1f} s")
    print(f"card: {card}")
    args.out.mkdir(parents=True, exist_ok=True)
    path = args.out / "results.json"
    path.write_text(json.dumps(to_json(results, args.device, card, args.reduced), indent=1,
                               default=str), encoding="utf-8")
    print(f"wrote {path}")
    return 1 if n_failed else 0


if __name__ == "__main__":
    sys.exit(main())
