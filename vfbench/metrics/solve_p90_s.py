"""90th percentile of every solve's wall in the measured window (host clock;
numpy's linear interpolation)."""
import numpy as np


def read(run):
    return float(np.percentile(run.walls, 90)) if run.walls else None
