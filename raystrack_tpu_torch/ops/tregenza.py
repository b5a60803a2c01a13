# Copied from raystrack_tpu/ops/tregenza.py: the ring table; the classifier rewritten in tensor ops.
"""Branchless Tregenza 145-patch sky classifier.

Eight altitude rings with (30, 30, 24, 24, 18, 12, 6, 1) azimuth patches;
the ring is the count of ring thresholds (sines of the rings' upper
altitude edges) at or below ``dz``; odd rings are offset by half a patch
width; downward directions (``dz <= 0``) map to -1. Float32 throughout, as
in the JAX package: only ``atan2`` may round apart from XLA's, which moves
a patch id only for a direction within an ulp of an azimuth edge.
"""
from __future__ import annotations

import numpy as np
import torch

# sin of the upper altitude edge of each ring (6, 18, ..., 84 deg, zenith cap)
RING_HI_SIN = np.array(
    [
        0.20791169081775934,
        0.40673664307580015,
        0.5877852522924731,
        0.7431448254773942,
        0.8660254037844386,
        0.9510565162951535,
        0.9945218953682733,
        1.0,
    ],
    dtype=np.float32,
)
RING_N = np.array([30, 30, 24, 24, 18, 12, 6, 1], dtype=np.int32)
RING_START = np.array([0, 30, 60, 84, 108, 126, 138, 144], dtype=np.int32)
TREGENZA_BINS = 145


def tregenza_patch_id(dx: torch.Tensor, dy: torch.Tensor, dz: torch.Tensor) -> torch.Tensor:
    """Patch id in [0, 144] of each unit direction, or -1 where ``dz <= 0``:
    int32 of the directions' (matching) shape, on their device."""
    device = dz.device
    hi = torch.from_numpy(RING_HI_SIN[:7]).to(device)
    # ring = first j with dz < hi[j]: the count of hi[j] <= dz (at most 6),
    # and 7 when dz reaches all seven thresholds
    ridx = (dz[..., None] >= hi).sum(dim=-1, dtype=torch.int32)
    n_az = torch.from_numpy(RING_N).to(device)[ridx.long()]
    base = torch.from_numpy(RING_START).to(device)[ridx.long()]

    az = torch.rad2deg(torch.atan2(dy, dx))
    az = torch.where(az < 0.0, az + 360.0, az)
    n_f = n_az.to(torch.float32)
    width = 360.0 / n_f
    off = torch.where((ridx & 1) == 1, 180.0 / n_f, 0.0)
    t = az - off
    t = torch.where(t < 0.0, t + 360.0, t)
    t = torch.where(t >= 360.0, t - 360.0, t)
    aidx = torch.minimum((t / width).to(torch.int32), n_az - 1)

    pid = torch.where(n_az == 1, base, base + aidx)
    return torch.where(dz > 0.0, pid, -1).to(torch.int32)


__all__ = ["tregenza_patch_id", "TREGENZA_BINS", "RING_HI_SIN", "RING_N", "RING_START"]
