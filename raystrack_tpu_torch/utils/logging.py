# Copied from raystrack_tpu/utils/logging.py, with its opt-in external console.
"""Injectable logging for solver progress lines.

The reference implementation writes per-emitter progress lines of the form
``"(i/n) [name] K iter, R rays -> T s (BVH=..., device=...)"`` through a
module-global ``_log`` that callers/tests may monkeypatch (reference:
src/raystrack/main.py:67-102, validation/common_validation.py:139-172).

We keep the same injectable contract but default to plain ``print``; the
external-console spawner is opt-in via ``RAYSTRACK_TPU_LOG_CONSOLE=1`` so
headless jobs never fork terminal subprocesses.
"""
from __future__ import annotations

import os
import subprocess
import sys
from typing import Callable, Optional

_LOG_PROC: Optional[subprocess.Popen] = None


def _open_log_console() -> None:
    global _LOG_PROC
    if _LOG_PROC is not None:
        return
    try:
        helper = [
            sys.executable,
            "-u",
            "-c",
            "import sys; [sys.stdout.write(l) for l in iter(sys.stdin.readline, '')]",
        ]
        if os.name == "nt":
            _LOG_PROC = subprocess.Popen(
                ["cmd.exe", "/k", *helper],
                stdin=subprocess.PIPE,
                creationflags=getattr(subprocess, "CREATE_NEW_CONSOLE", 0),
                text=True,
            )
        else:
            term = os.environ.get("TERM_WINDOW", "xterm")
            _LOG_PROC = subprocess.Popen(
                [term, "-hold", "-e", *helper], stdin=subprocess.PIPE, text=True
            )
    except Exception:
        _LOG_PROC = None


def _log(msg: str) -> None:
    """Default log sink: external console when opted in, else ``print``."""
    if os.environ.get("RAYSTRACK_TPU_LOG_CONSOLE", "0") in {"1", "true", "yes"}:
        if _LOG_PROC is None:
            _open_log_console()
        if _LOG_PROC is not None and _LOG_PROC.stdin:
            try:
                _LOG_PROC.stdin.write(msg + "\n")
                _LOG_PROC.stdin.flush()
                return
            except Exception:
                pass
    print(msg)


# Module-level mutable hook: solvers call ``log(...)`` which dereferences this
# at call time, so tests can monkeypatch ``raystrack_tpu_torch.solver._log`` exactly
# like the reference validation harness does with ``raystrack.main._log``.
LogFn = Callable[[str], None]

__all__ = ["_log", "LogFn"]
