"""Solver parameters of the PyTorch port.

Field for field the ``MatrixParams`` and ``SkyParams`` of
``raystrack_tpu.params``, so a parameter set moves between the two packages
unchanged; ``device`` names a PyTorch backend instead of a JAX one.
"""
from __future__ import annotations

from dataclasses import asdict, dataclass
from typing import Any, Dict

DEVICES = ("auto", "gpu", "cpu")


@dataclass
class MatrixParams:
    """Configuration for scene-to-scene view-factor solves.

    Parameters
    ----------
    samples : int
        Quasi-Monte Carlo sample density; the emission grid per emitter is
        ``g = max(4, ceil(sqrt(area * samples)))`` per side.
    rays : int
        Rays per grid cell.
    seed : int
        Base RNG seed. Each emitter/iteration derives its own sub-seed
        (``seed + emitter_index + iteration``).
    bvh : {"auto", "off", "builtin"}
        ``builtin`` Morton-orders the scene's triangles (which decides the
        order in which exact distance ties resolve) and, on scenes of more
        than one sweep tile, gates the sweep by per-tile AABBs, which skips
        tiles no ray of a 256-ray block can reach; ``auto`` turns it on at
        >= 512 faces. Results equal those of ``off`` up to the order in
        which exact distance ties resolve.
    device : {"auto", "gpu", "cpu"}
        ``auto`` picks the CUDA card when one is present, else the CPU;
        ``gpu`` requires a card; ``cpu`` runs the plain PyTorch sweep.
    cuda_async, gpu_raygen : bool
        Accepted for API compatibility; rays are always generated on the
        solve's device and work is queued asynchronously.
    max_iters : int
        Maximum number of Monte-Carlo iterations.
    tol : float
        Convergence tolerance. Interpretation depends on ``tol_mode``.
    tol_mode : {"delta", "stderr"}
        - "delta": stop when successive cumulative estimates change by < tol.
        - "stderr": stop when per-iteration replicate standard error is <= tol.
    min_iters : int
        Minimum number of Monte-Carlo iterations before a convergence check.
    convergence_interval : int
        Check convergence every N iterations on the card (every iteration
        on the CPU).
    reciprocity : bool
        Trace only receivers with a higher index and back-fill the
        transpose as F(j->i) = F(i->j) * Ai / Aj.
    enforce_reciprocity_rowsum : bool
        After computation, enforce reciprocity and make each row sum to 1
        using symmetric diagonal scaling.
    flip_faces : bool
        If True, flip emitter triangle winding during emission sampling.
    """

    samples: int = 16
    rays: int = 128
    seed: int = 1
    bvh: str = "auto"
    device: str = "auto"
    cuda_async: bool = True
    gpu_raygen: bool = True
    max_iters: int = 100
    tol: float = 1e-4
    tol_mode: str = "stderr"
    min_iters: int = 5
    convergence_interval: int = 1
    reciprocity: bool = True
    enforce_reciprocity_rowsum: bool = False
    flip_faces: bool = False

    def __post_init__(self) -> None:
        _check_device(self.device)

    def as_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "MatrixParams":
        return cls(**data)


@dataclass
class SkyParams:
    """Configuration for sky view-factor solves.

    Shares the sampling and convergence fields of :class:`MatrixParams`;
    see there.

    Parameters
    ----------
    discrete : bool
        If True, return the 145 Tregenza patches ``Sky_Patch_1`` ..
        ``Sky_Patch_145``; if False, one merged ``Sky`` entry: the fraction
        of rays that miss all geometry with an upward direction.
    """

    samples: int = 16
    rays: int = 128
    seed: int = 1
    bvh: str = "auto"
    device: str = "auto"
    cuda_async: bool = True
    gpu_raygen: bool = True
    max_iters: int = 100
    tol: float = 1e-4
    tol_mode: str = "stderr"
    min_iters: int = 5
    convergence_interval: int = 1
    discrete: bool = False

    def __post_init__(self) -> None:
        _check_device(self.device)

    def as_dict(self) -> Dict[str, Any]:
        return asdict(self)

    @classmethod
    def from_dict(cls, data: Dict[str, Any]) -> "SkyParams":
        return cls(**data)


def _check_device(device) -> None:
    if str(device).lower() not in DEVICES:
        raise ValueError(f"device must be 'auto', 'gpu', or 'cpu' (got {device!r})")


__all__ = ["MatrixParams", "SkyParams"]
