"""One reader a metric, ``<metric>.py`` with ``read(run) -> float | None``
over a ``harness.Run``; None where the run holds nothing to read."""
