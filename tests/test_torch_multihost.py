"""The port's multi-process solves (``raystrack_tpu_torch.parallel.multihost``).

Modelled on ``tests/test_multihost.py``: two real OS processes join a
``torch.distributed`` group on the gloo backend over localhost, each solves
its emitter partition, and both must end with the identical merged matrix,
sky and workflow, equal to the single-process solves. The worker is this
file run as a script::

    python tests/test_torch_multihost.py <host:port> <num_processes> <rank> <out.json>

No test starts a process group inside the pytest process.
"""
import json
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import raystrack_tpu_torch  # noqa: E402
from raystrack_tpu_torch import MatrixParams, SkyParams  # noqa: E402
from raystrack_tpu_torch.parallel import (  # noqa: E402
    initialize,
    ray_mesh,
    view_factor_matrix_multihost,
    view_factor_sky_multihost,
    view_factor_workflow_multihost,
)

# torch's own process-group environment: unset, a process runs alone
GROUP_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE", "LOCAL_RANK")


def scene():
    def square(name, size, z, normal=1, center=(0.0, 0.0)):
        cx, cy = center
        h = size / 2.0
        V = np.array([[cx - h, cy - h, z], [cx + h, cy - h, z], [cx + h, cy + h, z],
                      [cx - h, cy + h, z]], np.float32)
        F = (np.array([[0, 1, 2], [0, 2, 3]], np.int32) if normal >= 0
             else np.array([[0, 2, 1], [0, 3, 2]], np.int32))
        return name, V, F

    return [
        square("ground", 2.0, 0.0, normal=+1),
        square("mid", 1.5, 0.6, normal=-1, center=(0.4, 0.1)),
        square("top", 3.0, 1.2, normal=-1),
    ]


PARAMS = MatrixParams(samples=8, rays=64, seed=4, device="cpu", bvh="off", max_iters=6,
                      min_iters=3, tol=1e-3, reciprocity=True)
SKY_PARAMS = SkyParams(samples=8, rays=64, seed=4, device="cpu", bvh="off", max_iters=3,
                       min_iters=2, tol=1e-3)


def solve_all(mesh=None):
    """The matrix (its rays over ``mesh``), the discrete sky and the
    shared-ray workflow through the multi-process helpers, as JSON text."""
    import dataclasses

    matrix = view_factor_matrix_multihost(scene(), PARAMS, mesh=mesh)
    sky = view_factor_sky_multihost(scene(), dataclasses.replace(SKY_PARAMS, discrete=True))
    vf, wf_sky = view_factor_workflow_multihost(scene(), PARAMS, SKY_PARAMS)
    return json.dumps({"matrix": matrix, "sky": sky, "workflow": [vf, wf_sky]},
                      sort_keys=True)


def single_process():
    import dataclasses

    meshes = scene()
    return json.loads(json.dumps({
        "matrix": raystrack_tpu_torch.view_factor_matrix(meshes, PARAMS),
        "sky": raystrack_tpu_torch.view_factor_to_tregenza_sky(
            meshes, dataclasses.replace(SKY_PARAMS, discrete=True)),
        "workflow": list(raystrack_tpu_torch.view_factor_matrix_and_sky(
            meshes, matrix_params=PARAMS, sky_params=SKY_PARAMS)),
    }, sort_keys=True))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_two_process_solve(tmp_path):
    """Two processes on gloo over localhost: the same merged dicts in both,
    == the single-process solves (JSON keeps a float64's repr exactly)."""
    coordinator = f"127.0.0.1:{_free_port()}"
    outs = [tmp_path / f"proc{p}.json" for p in range(2)]
    env = {k: v for k, v in os.environ.items() if k not in GROUP_ENV}
    procs = [
        subprocess.Popen([sys.executable, __file__, coordinator, "2", str(p), str(outs[p])],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for p in range(2)
    ]
    try:
        single = single_process()
        logs = [p.communicate(timeout=300)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, log in zip(procs, logs):
        assert p.returncode == 0, log[-3000:]
    results = [json.loads(o.read_text()) for o in outs]
    assert results[0] == results[1]
    assert results[0] == single
    assert sum(len(row) for row in single["matrix"].values()) >= 3


def test_alone_the_helpers_equal_the_solvers(monkeypatch):
    """A process outside any group solves every emitter itself: the three
    helpers == the single-process solvers, with a ray mesh too."""
    import torch.distributed as dist

    for key in GROUP_ENV:
        monkeypatch.delenv(key, raising=False)
    assert json.loads(solve_all(ray_mesh(["cpu"] * 2))) == single_process()
    assert not dist.is_initialized()


def test_initialize_alone_starts_no_group(monkeypatch):
    import torch.distributed as dist

    for key in GROUP_ENV:
        monkeypatch.delenv(key, raising=False)
    assert initialize() == (0, 1)
    assert not dist.is_initialized()


def test_initialize_takes_all_three_arguments(monkeypatch):
    import pytest
    import torch.distributed as dist

    for key in GROUP_ENV:
        monkeypatch.delenv(key, raising=False)
    with pytest.raises(ValueError, match="go together"):
        initialize("127.0.0.1:1", num_processes=2)
    assert not dist.is_initialized()


def main() -> int:
    coordinator, num_processes, process_id, out = (
        sys.argv[1], int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    rank, count = initialize(coordinator_address=coordinator, num_processes=num_processes,
                             process_id=process_id)
    if (rank, count) != (process_id, num_processes):
        raise RuntimeError(f"initialize returned {(rank, count)}")
    try:
        text = solve_all(ray_mesh(["cpu"] * 2))
    finally:
        dist.destroy_process_group()
    Path(out).write_text(text, encoding="utf-8")
    return 0


if __name__ == "__main__":
    sys.exit(main())
