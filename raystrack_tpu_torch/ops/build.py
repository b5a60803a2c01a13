"""Build the package's CUDA sources with nvcc at first use and load them.

``csrc/*.cu`` compile into one shared library with a plain C interface,
written to ``build/raystrack_tpu_torch/`` beside the package and named by a
hash of the sources, the flags and the compiler, so a changed source
rebuilds and an unchanged one is reused. Each source compiles in its own
``nvcc`` process, all started together, and one more links them. The
library is loaded with ``ctypes``. Nothing is built from anywhere but
``csrc/``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from dataclasses import dataclass
from functools import lru_cache
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "raystrack_tpu_torch"

# --fmad=false and no fast math: every product and sum rounds on its own
# and division is IEEE, so the kernels agree bitwise with PyTorch's eager
# ops. -Xptxas=-v reports registers, shared memory and spills in the log.
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)


@dataclass(frozen=True)
class Build:
    path: Path  # the shared library
    seconds: float  # compile time; 0.0 when an earlier build was reused
    log: str  # nvcc's output ("" when reused)


def find_nvcc() -> str:
    """``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on ``PATH``, else the CUDA
    toolkit's default install location."""
    home = os.environ.get("CUDA_HOME")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for path in candidates:
        if os.path.isfile(path) and os.access(path, os.X_OK):
            return path
    raise RuntimeError(
        "nvcc not found (looked at $CUDA_HOME/bin/nvcc, PATH and "
        "/usr/local/cuda/bin/nvcc); the CUDA kernels need the CUDA toolkit"
    )


def build() -> Build:
    """Compile ``csrc/*.cu`` unless a library of the same sources and flags
    exists; raises with nvcc's output when a compile or the link fails."""
    nvcc = find_nvcc()
    sources = sorted(CSRC.glob("*.cu"))
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    digest = hashlib.sha256()
    for src in sources:
        digest.update(src.name.encode() + b"\0" + src.read_bytes() + b"\0")
    digest.update("\0".join((nvcc,) + NVCC_FLAGS).encode())
    lib = BUILD_DIR / f"libraystrack_kernels-{digest.hexdigest()[:16]}.so"
    if lib.exists():
        return Build(lib, 0.0, "")
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{digest.hexdigest()[:16]}.{os.getpid()}"
    objs = [BUILD_DIR / f"{src.stem}-{tag}.o" for src in sources]
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    t0 = time.perf_counter()
    procs = [
        (cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                               text=True))
        for cmd in ([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
                    for src, obj in zip(sources, objs))
    ]
    logs = [(cmd, proc.communicate()[0], proc.returncode) for cmd, proc in procs]
    link = [nvcc, "-shared", "-o", str(tmp), *map(str, objs)]
    if all(rc == 0 for _, _, rc in logs):
        proc = subprocess.run(link, capture_output=True, text=True)
        logs.append((link, proc.stdout + proc.stderr, proc.returncode))
    seconds = time.perf_counter() - t0
    for obj in objs:
        obj.unlink(missing_ok=True)
    log = "".join(out for _, out, _ in logs)
    failed = [(cmd, rc) for cmd, _, rc in logs if rc != 0]
    if failed:
        tmp.unlink(missing_ok=True)
        cmd, rc = failed[0]
        raise RuntimeError(f"nvcc failed ({rc}): {' '.join(cmd)}\n{log}")
    os.replace(tmp, lib)
    return Build(lib, seconds, log)


@lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """Build if needed, load, and declare the C entry points."""
    lib = ctypes.CDLL(str(build().path))
    fn = lib.raystrack_sweep_rays
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int,  # rays, n
        ctypes.c_void_p, ctypes.c_int,  # pack, n_tri_pad
        ctypes.c_void_p, ctypes.c_int,  # tiles_on, tile
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # want_matrix, want_any, baked
        ctypes.c_void_p, ctypes.c_void_p,  # codes, any
        ctypes.c_void_p,  # stream
    ]
    fn.restype = ctypes.c_int
    fn = lib.raystrack_count_codes
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p,  # codes, n_valid
        ctypes.c_int, ctypes.c_int, ctypes.c_int,  # rows, length, n_codes
        ctypes.c_void_p, ctypes.c_void_p,  # counts, stream
    ]
    fn.restype = ctypes.c_int
    fn = lib.raystrack_sweep_rays_scheduled
    fn.argtypes = [
        ctypes.c_void_p, ctypes.c_int,  # rays, n
        ctypes.c_void_p, ctypes.c_int,  # pack, n_tri_pad
        ctypes.c_void_p, ctypes.c_int,  # masks, n_emit
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,  # emap, tiles_on, tile
        ctypes.c_int, ctypes.c_int,  # want_matrix, want_any
        ctypes.c_void_p, ctypes.c_void_p,  # codes, any
        ctypes.c_void_p,  # stream
    ]
    fn.restype = ctypes.c_int
    return lib


__all__ = ["Build", "build", "find_nvcc", "load_library"]
