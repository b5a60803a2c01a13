"""The benchmark of raystrack_tpu_torch: converged view-factor solves timed
end to end on one CUDA card (see README.md)."""
