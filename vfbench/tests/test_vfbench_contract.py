"""BENCHMARK.json against the benchmark's contract, the data-driven layout,
and the command's refusals, on the CPU.

    python -m pytest vfbench/tests -q
"""
from __future__ import annotations

import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
HERE = ROOT / "vfbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
LINE = re.compile(r"^[^\t\n]{1,200}$")
FORBIDDEN = ("jax", "jaxlib", "flax", "raystrack_tpu", "examples", "benchmarks", "validation",
             "bench_torch", "chip_smoke", "chip_profile", "city_100m_torch")

sys.path.insert(0, str(ROOT))


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["vfbench"]
    assert BENCH["command"] == ["python3", "vfbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cells = len(BENCH["workloads"])
    assert 2 + 14 * 24 * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    assert 1 <= cells <= 24
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_lines():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and LINE.match(c["source"]) and LINE.match(c["why"])
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        names.append(c["name"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and LINE.match(w["why"])
        assert w["chips"] in (1, 4)
        names.append(w["name"])
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower",
                                                                                  "higher")
        names.append(m["name"])
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert LINE.match(m["layer"])
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    assert len(names) == len(set(names))
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    fours = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert fours <= max(1, len(BENCH["workloads"]) // 4)
    assert any(m["name"] == "setup_s" and m["bound"] <= 0.25 for m in BENCH["end_to_end"])


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_resolves_to_its_files(cell):
    from vfbench import harness

    c = harness.Cell.load(cell)
    w = {w["name"]: w for w in BENCH["workloads"]}[cell]
    conf = {c["name"]: c for c in BENCH["configs"]}[w["config"]]
    assert conf["file"].startswith("vfbench/") and (ROOT / conf["file"]).is_file()
    assert (HERE / "scenes" / f"{c.config['scene']}.py").is_file()
    assert (HERE / "traffic" / f"{w['traffic']}.json").is_file()
    assert (HERE / "limits" / f"{cell}.json").is_file()
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2 and c.per_layer
    for m in c.end_to_end + c.per_layer:
        assert (HERE / "metrics" / f"{m['name']}.py").is_file()
    for m in c.per_layer:
        assert m["moves"] in reported


def test_every_config_is_used_and_names_its_cuts():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        data = json.loads((ROOT / c["file"]).read_text())
        assert data["reduced"] == c["reduced"] and data["name"] == c["name"]
    assert len({c["file"] for c in BENCH["configs"]}) == len(BENCH["configs"])


def _imports(path: Path):
    src = path.read_text()
    return set(re.findall(r"^\s*(?:from|import)\s+([A-Za-z_][\w]*)", src, re.M))


def test_no_file_imports_the_jax_side_or_the_root_scripts():
    for path in HERE.rglob("*.py"):
        if "tests" in path.parts:
            continue
        assert not (_imports(path) & set(FORBIDDEN)), path
    for path in (HERE / "reference").rglob("*.py"):
        assert "raystrack_tpu_torch" not in _imports(path), path


def test_imports_leave_no_jax_in_sys_modules():
    code = ("import sys; sys.path.insert(0, %r)\n"
            "import vfbench.harness, vfbench.tracing, vfbench.reference.viewfactor\n"
            "from vfbench import harness\n"
            "for p in (harness.HERE / 'metrics').glob('*.py'): harness._module(p)\n"
            "for p in (harness.HERE / 'scenes').glob('*.py'): harness._module(p)\n"
            "import raystrack_tpu_torch\n"
            "print(sorted({m.split('.')[0] for m in sys.modules} & set(%r)))" % (str(ROOT),
                                                                              FORBIDDEN))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT)
    assert out.stdout.strip() == "[]"


def test_run_without_a_card_exits_non_zero_and_prints_no_result(tmp_path):
    cmd = [sys.executable, "vfbench/run.py", "--workload", BENCH["workloads"][0]["name"],
           "--seed", "2147483999", "--seconds", "1", "--trace", "0"]
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=ROOT)
    assert out.returncode != 0 and out.stdout == ""
    # a checkout with the benchmark alone (no program) prints no result either
    shutil.copytree(HERE, tmp_path / "vfbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run(cmd, capture_output=True, text=True, cwd=tmp_path)
    assert out.returncode != 0 and out.stdout == ""
