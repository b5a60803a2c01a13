# Copied from raystrack_tpu/ply.py (host-only): Stanford PLY meshes; files are byte-equal to the JAX package's.
"""Stanford PLY mesh ingestion (ascii and binary_little_endian).

Dependency-free loader for the subset that matters to view-factor scenes:
a ``vertex`` element with numeric ``x``/``y``/``z`` properties (any scalar
type; extra properties are skipped) and a ``face`` element with a
``vertex_indices``/``vertex_index`` list property (polygons are
fan-triangulated). Complements the OBJ loader (obj.py) — the reference
package reads geometry only from its own JSON format (reference:
src/raystrack/io.py:153-238).
"""
from __future__ import annotations

import struct
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

Mesh = Tuple[str, np.ndarray, np.ndarray]

_TYPES = {
    "char": "i1", "int8": "i1",
    "uchar": "u1", "uint8": "u1",
    "short": "i2", "int16": "i2",
    "ushort": "u2", "uint16": "u2",
    "int": "i4", "int32": "i4",
    "uint": "u4", "uint32": "u4",
    "float": "f4", "float32": "f4",
    "double": "f8", "float64": "f8",
}


class _Element:
    def __init__(self, name: str, count: int):
        self.name = name
        self.count = count
        self.props: List[Tuple[str, str, Optional[str]]] = []  # (name, type, list_count_type)


def _parse_header(blob: bytes, where: str):
    """Returns (format, [elements], data offset). Raises on malformed input."""
    end = blob.find(b"end_header")
    if not blob.startswith(b"ply") or end < 0:
        raise ValueError(f"{where}: not a PLY file (missing ply/end_header)")
    # data begins after the end_header line's newline
    data_start = blob.index(b"\n", end) + 1
    header = blob[:end].decode("ascii", errors="replace")

    fmt = None
    elements: List[_Element] = []
    for line_no, line in enumerate(header.splitlines(), 1):
        parts = line.strip().split()
        if not parts or parts[0] in ("ply", "comment", "obj_info"):
            continue
        tag = parts[0]
        if tag == "format":
            if len(parts) < 2 or parts[1] not in ("ascii", "binary_little_endian"):
                raise ValueError(
                    f"{where}: unsupported PLY format {' '.join(parts[1:])!r} "
                    f"(ascii and binary_little_endian are supported)"
                )
            fmt = parts[1]
        elif tag == "element":
            if len(parts) != 3:
                raise ValueError(f"{where}: line {line_no}: malformed element")
            elements.append(_Element(parts[1], int(parts[2])))
        elif tag == "property":
            if not elements:
                raise ValueError(f"{where}: line {line_no}: property before element")
            if parts[1] == "list":
                if len(parts) != 5:
                    raise ValueError(f"{where}: line {line_no}: malformed list property")
                count_t, item_t, name = parts[2], parts[3], parts[4]
                if count_t not in _TYPES or item_t not in _TYPES:
                    raise ValueError(f"{where}: line {line_no}: unknown list types")
                elements[-1].props.append((name, _TYPES[item_t], _TYPES[count_t]))
            else:
                if len(parts) != 3 or parts[1] not in _TYPES:
                    raise ValueError(f"{where}: line {line_no}: unknown property type")
                elements[-1].props.append((parts[2], _TYPES[parts[1]], None))
    if fmt is None:
        raise ValueError(f"{where}: header has no format line")
    return fmt, elements, data_start


def _triangulate(polys: List[List[int]], n_vertices: int, where: str) -> np.ndarray:
    tris: List[List[int]] = []
    for poly in polys:
        if len(poly) < 3:
            raise ValueError(f"{where}: face with fewer than 3 vertices")
        for k in range(1, len(poly) - 1):  # fan keeps the winding
            tris.append([poly[0], poly[k], poly[k + 1]])
    faces = np.asarray(tris, dtype=np.int64)
    if faces.size and (faces.min() < 0 or faces.max() >= n_vertices):
        raise ValueError(f"{where}: face references an undefined vertex")
    return faces.astype(np.int32)


def _read_ascii(tokens: List[str], elements: List[_Element], where: str):
    pos = 0
    parsed = {}
    for elem in elements:
        rows = []
        for _ in range(elem.count):
            row = {}
            for name, item_t, count_t in elem.props:
                if count_t is None:
                    row[name] = float(tokens[pos])
                    pos += 1
                else:
                    n = int(tokens[pos])
                    pos += 1
                    row[name] = [int(float(t)) for t in tokens[pos : pos + n]]
                    pos += n
            rows.append(row)
        parsed[elem.name] = rows
    return parsed


def _read_binary(data: bytes, elements: List[_Element], where: str):
    pos = 0
    parsed = {}
    for elem in elements:
        all_scalar = all(ct is None for _, _, ct in elem.props)
        if all_scalar:
            dtype = np.dtype([(n, "<" + t) for n, t, _ in elem.props])
            end = pos + dtype.itemsize * elem.count
            if end > len(data):
                raise ValueError(f"{where}: truncated binary data in {elem.name}")
            arr = np.frombuffer(data, dtype=dtype, count=elem.count, offset=pos)
            pos = end
            parsed[elem.name] = arr
            continue
        rows = []
        for _ in range(elem.count):
            row = {}
            for name, item_t, count_t in elem.props:
                if count_t is None:
                    size = np.dtype(item_t).itemsize
                    row[name] = struct.unpack_from(
                        "<" + {"f4": "f", "f8": "d", "i4": "i", "u4": "I",
                               "i2": "h", "u2": "H", "i1": "b", "u1": "B"}[item_t],
                        data, pos,
                    )[0]
                    pos += size
                else:
                    n = int(np.frombuffer(data, dtype="<" + count_t, count=1,
                                          offset=pos)[0])
                    pos += np.dtype(count_t).itemsize
                    idx = np.frombuffer(data, dtype="<" + item_t, count=n, offset=pos)
                    pos += np.dtype(item_t).itemsize * n
                    row[name] = idx.astype(np.int64).tolist()
            rows.append(row)
        if pos > len(data):
            raise ValueError(f"{where}: truncated binary data in {elem.name}")
        parsed[elem.name] = rows
    return parsed


def load_meshes_ply(load_path: str, *, name: Optional[str] = None) -> List[Mesh]:
    """Load a PLY file as a single named ``(name, V, F)`` mesh.

    Returns a one-element list for symmetry with the OBJ loader; the mesh
    name defaults to the file stem. Vertices come back float32, faces int32
    (polygons fan-triangulated, winding preserved).
    """
    path = Path(load_path)
    if not path.exists():
        raise FileNotFoundError(f"File not found: {load_path}")
    where = str(load_path)
    blob = path.read_bytes()
    fmt, elements, data_start = _parse_header(blob, where)

    names = {e.name for e in elements}
    if "vertex" not in names or "face" not in names:
        raise ValueError(f"{where}: PLY needs 'vertex' and 'face' elements")

    if fmt == "ascii":
        tokens = blob[data_start:].decode("ascii", errors="replace").split()
        parsed = _read_ascii(tokens, elements, where)
        verts_rows = parsed["vertex"]
        try:
            V = np.asarray(
                [[r["x"], r["y"], r["z"]] for r in verts_rows], dtype=np.float32
            )
        except KeyError:
            raise ValueError(f"{where}: vertex element lacks x/y/z properties")
        face_rows = parsed["face"]
    else:
        parsed = _read_binary(blob[data_start:], elements, where)
        verts = parsed["vertex"]
        if isinstance(verts, np.ndarray):
            fields = verts.dtype.names or ()
            if not {"x", "y", "z"} <= set(fields):
                raise ValueError(f"{where}: vertex element lacks x/y/z properties")
            V = np.stack(
                [verts["x"], verts["y"], verts["z"]], axis=1
            ).astype(np.float32)
        else:  # vertex element with a list property — unusual but legal
            V = np.asarray(
                [[r["x"], r["y"], r["z"]] for r in verts], dtype=np.float32
            )
        face_rows = parsed["face"]

    list_names = [n for e in elements if e.name == "face"
                  for n, _, ct in e.props if ct is not None]
    if not list_names:
        raise ValueError(f"{where}: face element has no list property")
    key = ("vertex_indices" if "vertex_indices" in list_names
           else "vertex_index" if "vertex_index" in list_names else list_names[0])
    polys = [r[key] for r in face_rows]
    F = _triangulate(polys, V.shape[0], where)
    if F.shape[0] == 0:
        raise ValueError(f"{where}: PLY file contains no faces")
    if V.ndim != 2 or V.shape[1] != 3:
        raise ValueError(f"{where}: vertex data is not (N, 3)")
    return [(name or path.stem, V, F)]


def save_mesh_ply(mesh: Mesh, save_path: str) -> str:
    """Write one ``(name, V, F)`` mesh as binary_little_endian PLY.

    Round-trips through :func:`load_meshes_ply` (the name travels as a
    comment; the loader's ``name=`` argument or the file stem restores it).
    """
    name, V, F = mesh
    V = np.asarray(V, dtype=np.float32)
    F = np.asarray(F, dtype=np.int32)
    if V.ndim != 2 or V.shape[1] != 3 or F.ndim != 2 or F.shape[1] != 3:
        raise ValueError(f"mesh {name!r} must be (N, 3) vertices and (M, 3) faces")
    path = Path(save_path)
    if not path.suffix:
        path = path.with_suffix(".ply")
    path.parent.mkdir(parents=True, exist_ok=True)

    header = (
        "ply\nformat binary_little_endian 1.0\n"
        f"comment mesh {name}\n"
        f"element vertex {V.shape[0]}\n"
        "property float x\nproperty float y\nproperty float z\n"
        f"element face {F.shape[0]}\n"
        "property list uchar int vertex_indices\nend_header\n"
    )
    parts = [header.encode("ascii"), V.astype("<f4").tobytes()]
    counts = np.full((F.shape[0], 1), 3, dtype=np.uint8)
    faces = F.astype("<i4")
    for c, f in zip(counts, faces):
        parts.append(c.tobytes() + f.tobytes())
    path.write_bytes(b"".join(parts))
    return str(path.resolve())


__all__ = ["load_meshes_ply", "save_mesh_ply"]
