"""FP32 FMA-peak probe: the CUDA kernel's wrapper and its plain version.

Counterpart of the JAX package's ``docs/measurements/vpu_roofline_r05.py``
``measure_peak`` (kernel body ``_fma_kernel``): on a ``(32, 128)`` f32
block, ``CHAINS`` independent accumulators ``x + i`` each run ``DEPTH``
dependent ``a * c + d`` and are summed in order; the block is repeated
``REPEATS`` times, ``fma_count()`` = 1.374e11 FMAs in one launch. The
kernel lives in ``csrc/peak.cu``. No solve calls it: it measures the rate
the sweeps' share of peak is stated against.

The kernel issues fused multiply-adds, which round once; the plain version's
``a * c + d`` rounds twice. Both stay within :func:`fma_peak_tolerance` of
the exact recurrence, so within twice that of each other.
"""
from __future__ import annotations

import torch

ROWS, LANES = 32, 128
CHAINS = 16
DEPTH = 1024
REPEATS = 2048


def fma_count(repeats: int = REPEATS) -> int:
    """Fused multiply-adds of one launch."""
    return repeats * CHAINS * DEPTH * ROWS * LANES


def _check(x: torch.Tensor) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError("x must be a torch.Tensor")
    if x.dtype != torch.float32:
        raise TypeError(f"x must be torch.float32 (got {x.dtype})")
    if tuple(x.shape) != (ROWS, LANES) or not x.is_contiguous():
        raise ValueError(f"x must be a contiguous ({ROWS}, {LANES}) tensor "
                         f"(got {tuple(x.shape)})")


def _f32(v: float) -> float:
    """``v`` rounded to float32, as the kernel receives its scalars."""
    return float(torch.tensor(v, dtype=torch.float32))


def fma_peak_reference(x: torch.Tensor, c: float, d: float,
                       repeats: int = REPEATS) -> torch.Tensor:
    """Plain version of the probe in tensor ops: the 16 chains as one
    ``(16, 32, 128)`` tensor stepped ``DEPTH`` times, summed in chain order;
    ``(repeats, 32, 128)``, every repeat a view of the one result. Works in
    the dtype of ``x``, so a float64 ``x`` gives the recurrence both f32
    versions are held against."""
    c, d = _f32(c), _f32(d)
    steps = torch.arange(CHAINS, dtype=x.dtype, device=x.device)
    a = x[None] + steps[:, None, None]
    for _ in range(DEPTH):
        a = a * c + d
    s = a[0]
    for i in range(1, CHAINS):
        s = s + a[i]
    return s[None].expand(repeats, ROWS, LANES)


def fma_peak_tolerance(x: torch.Tensor, c: float, d: float) -> float:
    """Largest |f32 result - exact result| either f32 version can reach,
    reckoned from the float64 recurrence: each of the ``CHAINS * DEPTH``
    steps rounds at most twice, each rounding moving its chain by at most
    half an ulp of the largest accumulator magnitude ``a_max`` (so one ulp
    per step; with |c| <= 1 an earlier error is never amplified), and the
    ``CHAINS`` additions of the start and of the sum each add at most half
    an ulp of the largest partial sum. An ulp of v is at most 2**-23 |v|."""
    c, d = _f32(c), _f32(d)
    if abs(c) > 1.0:
        raise ValueError("the bound assumes |c| <= 1")
    x64 = x.detach().double().cpu()  # on the host: it reads a maximum back at every step
    a = x64[None] + torch.arange(CHAINS, dtype=torch.float64)[:, None, None]
    a_max = float(a.abs().max())
    for _ in range(DEPTH):
        a = a * c + d
        a_max = max(a_max, float(a.abs().max()))
    s_max = float(a.abs().sum(dim=0).max())
    ulp = 2.0 ** -23
    return CHAINS * DEPTH * ulp * a_max + CHAINS * ulp * (a_max + s_max)


def fma_peak(x: torch.Tensor, c: float, d: float, repeats: int = REPEATS) -> torch.Tensor:
    """Run the probe on ``x`` (32, 128) f32 with the scalars ``c`` and ``d``;
    returns ``(repeats, 32, 128)`` f32, every repeat computed on its own.

    CUDA tensors go to the kernel of ``csrc/peak.cu`` (launched on the
    current stream, not synchronised; ``fma_peak.launches`` counts the
    launches); CPU tensors go to :func:`fma_peak_reference`.
    """
    _check(x)
    repeats = int(repeats)
    if repeats < 0:
        raise ValueError("repeats must not be negative")
    device = x.device
    if device.type == "cpu":
        return fma_peak_reference(x, c, d, repeats)
    if device.type != "cuda":
        raise ValueError(f"fma_peak runs on cuda or cpu tensors (got {device})")
    from .build import load_library

    lib = load_library()
    out = torch.empty((repeats, ROWS, LANES), dtype=torch.float32, device=device)
    if repeats == 0:  # nothing to launch
        return out
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = lib.raystrack_fma_peak(x.data_ptr(), float(c), float(d), repeats,
                                     out.data_ptr(), stream)
    if err != 0:
        raise RuntimeError(f"FMA-peak kernel launch failed: CUDA error {err}")
    fma_peak.launches += 1
    return out


fma_peak.launches = 0

__all__ = ["fma_peak", "fma_peak_reference", "fma_peak_tolerance", "fma_count",
           "ROWS", "LANES", "CHAINS", "DEPTH", "REPEATS"]
