# Copied from raystrack_tpu/utils/logging.py, without its opt-in external console.
"""Injectable logging for solver progress lines.

Solvers write per-emitter progress lines of the form
``"(i/n) [name] K iter, R rays -> T s (BVH=..., device=...)"`` through a
module-global ``_log`` that callers and tests may monkeypatch; external
harnesses regex-parse ``[name] K iter``, so the format must not change.
"""
from __future__ import annotations


def _log(msg: str) -> None:
    """Default log sink: ``print``."""
    print(msg)


__all__ = ["_log"]
