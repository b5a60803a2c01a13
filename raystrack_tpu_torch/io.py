# Copied from raystrack_tpu/io.py (host-only JSON and NumPy): matrix and mesh files, and the streamed matrix writer.
"""JSON persistence for view-factor matrices and mesh geometry.

File-format compatible with the reference package (its matrix files are
``{sender: {receiver: value}}`` with exact zeros pruned, and its mesh files
are ``{"meshes": [{"name", "vertices", "faces"}, ...]}`` — reference:
src/raystrack/io.py), so results and scenes round-trip between the two.
The code itself is organized around two small validation helpers rather
than per-function checks.

Behaviors preserved for compatibility:

- saving prunes receivers whose value is exactly ``0.0``,
- ``strip_dir`` folds ``_front``/``_back`` suffixes and sums same-base keys,
- a missing file extension becomes ``.json`` and parent dirs are created,
- ``merge_vf_matrix`` accepts a dict (returned as-is) or a list of dicts
  whose rows are deep-merged, later entries winning per receiver key.
"""
from __future__ import annotations

import itertools
import json
from pathlib import Path
from typing import Dict, List, Tuple, Union

import numpy as np

from .utils.helpers import strip_direction

VFDict = Dict[str, Dict[str, float]]
VFInput = Union[VFDict, List[VFDict]]
MeshTuple = Tuple[str, np.ndarray, np.ndarray]
Meshes = List[MeshTuple]


# ---------------------------------------------------------------------------
# Shared validation / path plumbing
# ---------------------------------------------------------------------------


def _checked_rows(data, *, where: str) -> VFDict:
    """Validate ``{str: {str: number}}`` nesting and coerce values to float."""
    if not isinstance(data, dict):
        raise TypeError(f"{where}: expected a mapping of sender -> row")
    out: VFDict = {}
    for sender, row in data.items():
        if not isinstance(sender, str):
            raise TypeError(f"{where}: sender key {sender!r} is not a string")
        if not isinstance(row, dict):
            raise TypeError(f"{where}: row of {sender!r} is not a mapping")
        coerced: Dict[str, float] = {}
        for recv, value in row.items():
            if not isinstance(recv, str):
                raise TypeError(
                    f"{where}: receiver key {recv!r} under {sender!r} is not a string"
                )
            try:
                coerced[recv] = float(value)
            except (TypeError, ValueError):
                raise TypeError(
                    f"{where}: {sender!r} -> {recv!r} value {value!r} is not numeric"
                )
        out[sender] = coerced
    return out


def _checked_mesh(name, V, F, *, where: str) -> MeshTuple:
    if not isinstance(name, str) or not name.strip():
        raise TypeError(f"{where}: mesh name must be a non-empty string")
    V = np.asarray(V, dtype=np.float32)
    F = np.asarray(F, dtype=np.int32)
    if V.ndim != 2 or V.shape[1] != 3:
        raise ValueError(f"{where}: {name!r} vertices must be (N, 3)")
    if F.ndim != 2 or F.shape[1] != 3:
        raise ValueError(f"{where}: {name!r} faces must be (M, 3) triangles")
    return name, V, F


def _out_path(save_path: str) -> Path:
    path = Path(save_path)
    if not path.suffix:
        path = path.with_suffix(".json")
    path.parent.mkdir(parents=True, exist_ok=True)
    return path


def _read_json(load_path: str):
    path = Path(load_path)
    if not path.exists():
        raise FileNotFoundError(f"File not found: {load_path}")
    return json.loads(path.read_text(encoding="utf-8"))


# ---------------------------------------------------------------------------
# View-factor matrices
# ---------------------------------------------------------------------------


def merge_vf_matrix(vf_matrix: VFInput) -> VFDict:
    """Flatten a dict, or deep-merge a list of dicts, into one VF matrix.

    Repeated senders across list entries merge their receiver maps; later
    entries overwrite earlier ones only where receiver keys collide. This is
    the combiner for partial results (multi-host partitions, checkpoints).
    """
    if isinstance(vf_matrix, dict):
        return vf_matrix
    if not isinstance(vf_matrix, list):
        raise TypeError("vf_matrix must be a dict or a list of dicts")
    merged: VFDict = {}
    for part in vf_matrix:
        if not isinstance(part, dict):
            raise TypeError("every element of a vf_matrix list must be a dict")
        for sender, row in part.items():
            merged.setdefault(sender, {}).update(row)
    return merged


def save_vf_matrix_json(
    vf_matrix: VFInput, save_path: str, *, strip_dir: bool = False
) -> str:
    """Write a VF matrix (or list of partial matrices) as JSON.

    Exact zeros are pruned; ``strip_dir=True`` folds direction suffixes,
    summing front/back contributions per base name. Returns the resolved
    output path (extensionless paths gain ``.json``).
    """
    rows = _checked_rows(merge_vf_matrix(vf_matrix), where="vf_matrix")
    pruned: VFDict = {}
    for sender, row in rows.items():
        kept: Dict[str, float] = {}
        for recv, value in row.items():
            if value == 0.0:
                continue
            key = strip_direction(recv) if strip_dir else recv
            kept[key] = kept.get(key, 0.0) + value
        pruned[sender] = kept

    path = _out_path(save_path)
    path.write_text(
        json.dumps(pruned, ensure_ascii=False, indent=2, sort_keys=True),
        encoding="utf-8",
    )
    return str(path.resolve())


def load_vf_matrix_json(load_path: str) -> VFDict:
    """Read a VF matrix JSON file back into ``{sender: {receiver: float}}``."""
    return _checked_rows(_read_json(load_path), where=load_path)


class VFMatrixStreamWriter:
    """Incremental VF-matrix JSON writer for results too large to hold.

    Produces the same format as :func:`save_vf_matrix_json` (zero pruning,
    optional ``strip_dir`` folding, per-row sorted keys) but one sender row
    at a time, so a million-emitter sweep can stream its matrix to disk as
    emitters converge instead of accumulating the whole dict in memory.
    Rows appear in write order. The file is written to a per-process temp
    name and atomically published on ``close()``; an abandoned writer (error
    before close) leaves no partial output at the target path.

        with VFMatrixStreamWriter("vf.json") as w:
            for name, row in solve_rows(...):
                w.write_row(name, row)
    """

    _instance_seq = itertools.count()

    def __init__(self, save_path: str, *, strip_dir: bool = False):
        import os

        self._path = _out_path(save_path)
        # pid + per-process sequence number: two writers in one process
        # targeting the same path must not share a temp file.
        self._tmp = self._path.with_suffix(
            f".{os.getpid()}.{next(self._instance_seq)}.tmp"
        )
        self._fh = self._tmp.open("w", encoding="utf-8")
        self._fh.write("{")
        self._strip_dir = bool(strip_dir)
        self._seen: set = set()
        self._closed = False

    def write_row(self, sender: str, row: Dict[str, float]) -> None:
        """Append one sender's receiver map (validated, pruned, folded)."""
        if self._closed:
            raise ValueError("VFMatrixStreamWriter is closed")
        checked = _checked_rows({sender: row}, where="write_row")
        if sender in self._seen:
            raise ValueError(f"duplicate sender row {sender!r}")
        kept: Dict[str, float] = {}
        for recv, value in checked[sender].items():
            if value == 0.0:
                continue
            key = strip_direction(recv) if self._strip_dir else recv
            kept[key] = kept.get(key, 0.0) + value
        prefix = ",\n" if self._seen else "\n"
        self._fh.write(
            f"{prefix}  {json.dumps(sender, ensure_ascii=False)}: "
            + json.dumps(kept, ensure_ascii=False, sort_keys=True)
        )
        self._seen.add(sender)

    def close(self) -> str:
        """Finish the JSON document and atomically publish it."""
        if self._closed:
            return str(self._path.resolve())
        self._closed = True
        self._fh.write("\n}\n" if self._seen else "}\n")
        self._fh.close()
        self._tmp.replace(self._path)
        return str(self._path.resolve())

    def abort(self) -> None:
        """Discard the partial file without publishing."""
        if not self._closed:
            self._closed = True
            self._fh.close()
            self._tmp.unlink(missing_ok=True)

    def __enter__(self) -> "VFMatrixStreamWriter":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        if exc_type is None:
            self.close()
        else:
            self.abort()


# ---------------------------------------------------------------------------
# Mesh geometry
# ---------------------------------------------------------------------------


def save_meshes_json(meshes: Meshes, save_path: str) -> str:
    """Write ``[(name, V, F), ...]`` scene geometry as JSON."""
    if not isinstance(meshes, list):
        raise TypeError("meshes must be a list of (name, V, F) tuples")
    records = []
    for item in meshes:
        if not (isinstance(item, tuple) and len(item) == 3):
            raise TypeError("each mesh must be a (name, V, F) tuple")
        name, V, F = _checked_mesh(*item, where="save_meshes_json")
        records.append({"name": name, "vertices": V.tolist(), "faces": F.tolist()})

    path = _out_path(save_path)
    path.write_text(
        json.dumps({"meshes": records}, ensure_ascii=False, indent=2),
        encoding="utf-8",
    )
    return str(path.resolve())


def load_meshes_json(load_path: str) -> Meshes:
    """Read scene geometry written by :func:`save_meshes_json`.

    Returns ``[(name, V, F), ...]`` with float32 vertices and int32 faces.
    """
    data = _read_json(load_path)
    if not isinstance(data, dict) or not isinstance(data.get("meshes"), list):
        raise TypeError(f"{load_path}: expected an object with a 'meshes' list")
    out: Meshes = []
    for i, record in enumerate(data["meshes"]):
        if not isinstance(record, dict):
            raise TypeError(f"{load_path}: meshes[{i}] is not an object")
        out.append(
            _checked_mesh(
                record.get("name"),
                record.get("vertices"),
                record.get("faces"),
                where=f"{load_path}: meshes[{i}]",
            )
        )
    return out


__all__ = [
    "merge_vf_matrix",
    "save_vf_matrix_json",
    "load_vf_matrix_json",
    "VFMatrixStreamWriter",
    "save_meshes_json",
    "load_meshes_json",
]
