"""The solves' dispatch trace, pinned: what the drivers send to the sweeps
and write to the checkpoint store, in order, on a small CPU scene.

Ten plates and a ground (``tests/test_torch_slots.py``'s scene), solved as
a matrix (with ``row_sink``), a discrete sky and the shared-ray workflow,
each on the scheduled route and on the per-emitter route, with
``checkpoint_dir=`` and a progress snapshot after every chunk or round;
and a workflow stopped at its first finished emitter, then resumed from
the snapshots. Each case records, in call order:

- every ``_EmitterRun.dispatch_chunk``: emitter, ``itr_next``, chunk, the
  three flags and the slot;
- every ``parallel.sharding.scheduled_trace_sharded``: its flags, the
  schedule's shape, and digests of the schedule, the CP rows and the
  emitter rows;
- every ``_CheckpointStore.save`` and ``save_progress``: emitter, keys and
  a digest of the payload as written;
- the progress log lines, their seconds masked;

and then a digest of the returned dicts. The expected values are literals
recorded on the solver as it stood before its drivers were merged, so any
change to the order of dispatches, their flags, the rounds, the snapshots
or the dicts shows here. To print them anew:

    JAX_PLATFORMS=cpu python tests/test_torch_drive_trace.py
"""
import hashlib
import json
import re
import sys
import tempfile
from pathlib import Path

import numpy as np
import pytest
import torch

import raystrack_tpu_torch as rt
import raystrack_tpu_torch.solver as solver_mod
from raystrack_tpu_torch import config
from raystrack_tpu_torch.parallel import sharding

N_PLATES = 10
BASE = dict(samples=2, rays=8, seed=7, device="cpu", bvh="off")
CASES = ["matrix-scheduled", "matrix-grouped", "sky-scheduled", "sky-grouped",
         "workflow-scheduled", "workflow-grouped", "workflow-resumed"]


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: beside other test workers, more threads only
    contend for the same cores."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n_threads)


def _quad(x0, x1, y0, y1, z, up):
    v = np.array([[x0, y0, z], [x1, y0, z], [x1, y1, z], [x0, y1, z]], np.float32)
    f = np.array([[0, 1, 2], [0, 2, 3]] if up else [[0, 2, 1], [0, 3, 2]], np.int32)
    return v, f


def _plates(n=N_PLATES):
    """``n`` plates side by side at z = 1 facing down, then a ground facing
    up: under reciprocity each plate's one receiver is the ground, and the
    ground, last, has none."""
    meshes = [(f"plate{i}", *_quad(2.0 * i, 2.0 * i + 1.5, 0.0, 1.5, 1.0, up=False))
              for i in range(n)]
    return meshes + [("ground", *_quad(-1.0, 2.0 * n + 1.0, -1.0, 2.5, 0.0, up=True))]


def _digest(*parts) -> str:
    h = hashlib.sha256()
    for a in parts:
        if isinstance(a, torch.Tensor):
            a = a.detach().cpu().numpy()
        if isinstance(a, np.ndarray):
            h.update(f"{a.dtype}{a.shape}".encode())
            h.update(np.ascontiguousarray(a).tobytes())
        else:
            h.update(json.dumps(a, sort_keys=True).encode())
    return h.hexdigest()[:12]


def _flags(want_matrix, want_any, discrete):
    return "".join("TF"[not f] for f in (want_matrix, want_any, discrete))


def _hooks(mp, events):
    """Record the dispatches, rounds, checkpoint writes and log lines."""
    dispatch = solver_mod._EmitterRun.dispatch_chunk

    def logged_dispatch(self, chunk, **kw):
        events.append(f"d {self.idx_emit} {self.itr_next} {chunk} "
                      f"{_flags(kw['want_matrix'], kw['want_any'], kw['discrete'])} "
                      f"{kw['slot'].index}")
        return dispatch(self, chunk, **kw)

    scheduled = sharding.scheduled_trace_sharded

    def logged_round(mesh, scene, tri_pack, tables, geom, cp, surf, emit, min_sid, once,
                     plane, schedule, sel, **kw):
        events.append(f"r {_flags(kw['want_matrix'], kw['want_any'], kw['discrete'])} "
                      f"{tuple(schedule.shape)} {_digest(schedule)} {_digest(cp)} "
                      f"{_digest(surf, emit, min_sid, once, plane, sel)}")
        return scheduled(mesh, scene, tri_pack, tables, geom, cp, surf, emit, min_sid, once,
                         plane, schedule, sel, **kw)

    save, save_progress = solver_mod._CheckpointStore.save, solver_mod._CheckpointStore.save_progress

    def logged_save(self, idx, name, row, backfill, stats, **extra):
        payload = dict(row=row, backfill=backfill, stats=stats, **extra)
        events.append(f"s {idx} {name} {','.join(sorted(payload))} {_digest(payload)}")
        return save(self, idx, name, row, backfill, stats, **extra)

    def logged_progress(self, idx, state):
        events.append(f"p {idx} {','.join(sorted(state))} {_digest(state)}")
        return save_progress(self, idx, state)

    mp.setattr(solver_mod._EmitterRun, "dispatch_chunk", logged_dispatch)
    mp.setattr(sharding, "scheduled_trace_sharded", logged_round)
    mp.setattr(solver_mod._CheckpointStore, "save", logged_save)
    mp.setattr(solver_mod._CheckpointStore, "save_progress", logged_progress)
    mp.setattr(solver_mod, "_log",
               lambda line: events.append("l " + re.sub(r"\d+\.\d{3}s", "#s", line)))


def _solve(kind, meshes, ckpt, sunk):
    matrix = rt.MatrixParams(**BASE, min_iters=2, max_iters=40, tol=8e-3, reciprocity=True)
    sky = rt.SkyParams(**BASE, min_iters=2, max_iters=12, tol=3e-3, discrete=True)
    if kind == "matrix":
        return solver_mod.view_factor_matrix(
            meshes, matrix, return_stats=True, checkpoint_dir=ckpt,
            row_sink=lambda name, row: sunk.append(f"k {name} {_digest(row)}"))
    if kind == "sky":
        return solver_mod.view_factor_to_tregenza_sky(meshes, sky, return_stats=True,
                                                      checkpoint_dir=ckpt)
    return solver_mod.view_factor_matrix_and_sky(meshes, matrix_params=matrix,
                                                 sky_params=sky, return_stats=True,
                                                 checkpoint_dir=ckpt)


def _record(case, tmp_dir, mp):
    """The events of ``case`` and the digest of its dicts."""
    kind, route = case.split("-")
    mp.setattr(config, "SCHEDULER", "grouped" if route == "resumed" else route)
    mp.setattr(config, "CHECKPOINT_PROGRESS_S", 0.0)
    meshes, events = _plates(), []
    ckpt = str(Path(tmp_dir) / "ckpt")
    _hooks(mp, events)
    if route == "resumed":
        boom = RuntimeError("stopped mid-solve")

        def crash(entry):
            raise boom

        with mp.context() as stop:
            stop.setattr(solver_mod, "_entry_done", crash)
            with pytest.raises(RuntimeError) as err:
                _solve(kind, meshes, ckpt, events)
            assert err.value is boom
        events.append("resume")
    out = _solve(kind, meshes, ckpt, events)
    return events, _digest(out)


@pytest.mark.parametrize("case", CASES)
def test_drive_trace(case, tmp_path, monkeypatch):
    events, result = _record(case, tmp_path, monkeypatch)
    assert events == EXPECTED[case][0]
    assert result == EXPECTED[case][1]


EXPECTED = {
    'matrix-scheduled': ([
        'l (11/11) [ground] 0 iter, 0 rays -> #s  (BVH=off, device=cpu)',
        's 10 ground backfill,row,stats da2a7edc778c',
        'r TFF (20, 4) 5379ca9d7218 e33d7d38d68d 5c8207042971',
        'r TFF (10, 4) 798ea21b1028 0b0627b3cebd 5c8207042971',
        'p 0 monitor e09720937f64',
        'p 1 monitor cf9c2e7eadf0',
        'p 2 monitor 21f910974bb5',
        'p 3 monitor 2146ce1205b4',
        'p 4 monitor 76ef2aadd545',
        's 5 plate5 backfill,row,stats 9df0751f8537',
        's 6 plate6 backfill,row,stats 7e7ac35f82b3',
        's 7 plate7 backfill,row,stats 2a114383a584',
        's 8 plate8 backfill,row,stats a3e8876e18dd',
        'p 9 monitor 3217be3629fa',
        'r TFF (71, 4) 924f4299f38a b40a5acb6869 bf1fda447733',
        'p 0 monitor 2b2f6b250f58',
        'p 1 monitor e5b65e4abefa',
        'p 2 monitor 8333a85c9f68',
        'p 3 monitor b1a4965ac3e6',
        'p 4 monitor b1a4965ac3e6',
        'p 9 monitor 1885a14991b1',
        'r TFF (33, 4) 0373b379ef68 0ab3b1f04205 bf1fda447733',
        's 0 plate0 backfill,row,stats 3e3a5fdc706b',
        'k plate0 12ca4c472c4e',
        'p 1 monitor 4518d016434b',
        's 2 plate2 backfill,row,stats 44808822fb3b',
        's 3 plate3 backfill,row,stats 0d39064c7360',
        's 4 plate4 backfill,row,stats 43f185a70fe1',
        's 9 plate9 backfill,row,stats f02a081a1add',
        'r TFF (4, 4) 8f6cec11feb2 d0bd6fbcfc87 5964c4f8bae4',
        's 1 plate1 backfill,row,stats 35785ee7295c',
        'k plate1 e456dddf0102',
        'k plate2 e7429c77b178',
        'k plate3 3fb886239b14',
        'k plate4 a59be9fc6030',
        'k plate5 50325b83e674',
        'k plate6 50325b83e674',
        'k plate7 e7429c77b178',
        'k plate8 e7429c77b178',
        'k plate9 f32f45cc0b50',
        'k ground 43ae44b395f3',
        'l (1/11) [plate0] 7 iter, 896 rays -> #s  (BVH=off, device=cpu)',
        'l (2/11) [plate1] 9 iter, 1,152 rays -> #s  (BVH=off, device=cpu)',
        'l (3/11) [plate2] 8 iter, 1,024 rays -> #s  (BVH=off, device=cpu)',
        'l (4/11) [plate3] 7 iter, 896 rays -> #s  (BVH=off, device=cpu)',
        'l (5/11) [plate4] 6 iter, 768 rays -> #s  (BVH=off, device=cpu)',
        'l (6/11) [plate5] 2 iter, 256 rays -> #s  (BVH=off, device=cpu)',
        'l (7/11) [plate6] 2 iter, 256 rays -> #s  (BVH=off, device=cpu)',
        'l (8/11) [plate7] 2 iter, 256 rays -> #s  (BVH=off, device=cpu)',
        'l (9/11) [plate8] 2 iter, 256 rays -> #s  (BVH=off, device=cpu)',
        'l (10/11) [plate9] 5 iter, 640 rays -> #s  (BVH=off, device=cpu)',
    ], '1cfbcbaabf20'),
    'matrix-grouped': ([
        'l (11/11) [ground] 0 iter, 0 rays -> #s  (BVH=off, device=cpu)',
        's 10 ground backfill,row,stats da2a7edc778c',
        'd 0 0 1 TFF 0',
        'd 1 0 1 TFF 1',
        'd 2 0 1 TFF 2',
        'p 0 monitor f2774b0535c5',
        'd 3 0 1 TFF 0',
        'p 1 monitor 3f8617922ed8',
        'd 4 0 1 TFF 1',
        'p 2 monitor 8bf21ab95151',
        'd 5 0 1 TFF 2',
        'p 3 monitor e99d76857e86',
        'd 6 0 1 TFF 0',
        'p 4 monitor 4c5be323bfe7',
        'd 7 0 1 TFF 1',
        'p 5 monitor 5c23b5c53a56',
        'd 8 0 1 TFF 2',
        'p 6 monitor e99d76857e86',
        'd 9 0 1 TFF 0',
        'p 7 monitor 5c23b5c53a56',
        'd 0 1 1 TFF 1',
        'p 8 monitor 1dc975572c32',
        'd 1 1 1 TFF 2',
        'p 9 monitor 6ae9130fda2b',
        'd 2 1 1 TFF 0',
        'p 0 monitor e09720937f64',
        'd 3 1 1 TFF 1',
        'p 1 monitor cf9c2e7eadf0',
        'd 4 1 1 TFF 2',
        'p 2 monitor 21f910974bb5',
        'd 5 1 1 TFF 0',
        'p 3 monitor 2146ce1205b4',
        'd 6 1 1 TFF 1',
        'p 4 monitor 76ef2aadd545',
        'd 7 1 1 TFF 2',
        's 5 plate5 backfill,row,stats 9df0751f8537',
        'd 8 1 1 TFF 0',
        's 6 plate6 backfill,row,stats 7e7ac35f82b3',
        'd 9 1 1 TFF 1',
        's 7 plate7 backfill,row,stats 2a114383a584',
        'd 0 2 16 TFF 2',
        's 8 plate8 backfill,row,stats a3e8876e18dd',
        'd 1 2 1 TFF 0',
        'p 9 monitor 3217be3629fa',
        'd 2 2 16 TFF 1',
        's 0 plate0 backfill,row,stats 3e3a5fdc706b',
        'k plate0 12ca4c472c4e',
        'd 3 2 16 TFF 2',
        'p 1 monitor e5b65e4abefa',
        'd 4 2 4 TFF 0',
        's 2 plate2 backfill,row,stats 44808822fb3b',
        'd 9 2 4 TFF 1',
        's 3 plate3 backfill,row,stats 0d39064c7360',
        'd 1 3 4 TFF 2',
        's 4 plate4 backfill,row,stats 43f185a70fe1',
        's 9 plate9 backfill,row,stats f02a081a1add',
        'p 1 monitor b502245c9b75',
        'd 1 7 4 TFF 0',
        's 1 plate1 backfill,row,stats 35785ee7295c',
        'k plate1 e456dddf0102',
        'k plate2 e7429c77b178',
        'k plate3 3fb886239b14',
        'k plate4 a59be9fc6030',
        'k plate5 50325b83e674',
        'k plate6 50325b83e674',
        'k plate7 e7429c77b178',
        'k plate8 e7429c77b178',
        'k plate9 f32f45cc0b50',
        'k ground 43ae44b395f3',
        'l (1/11) [plate0] 7 iter, 896 rays -> #s  (BVH=off, device=cpu)',
        'l (2/11) [plate1] 9 iter, 1,152 rays -> #s  (BVH=off, device=cpu)',
        'l (3/11) [plate2] 8 iter, 1,024 rays -> #s  (BVH=off, device=cpu)',
        'l (4/11) [plate3] 7 iter, 896 rays -> #s  (BVH=off, device=cpu)',
        'l (5/11) [plate4] 6 iter, 768 rays -> #s  (BVH=off, device=cpu)',
        'l (6/11) [plate5] 2 iter, 256 rays -> #s  (BVH=off, device=cpu)',
        'l (7/11) [plate6] 2 iter, 256 rays -> #s  (BVH=off, device=cpu)',
        'l (8/11) [plate7] 2 iter, 256 rays -> #s  (BVH=off, device=cpu)',
        'l (9/11) [plate8] 2 iter, 256 rays -> #s  (BVH=off, device=cpu)',
        'l (10/11) [plate9] 5 iter, 640 rays -> #s  (BVH=off, device=cpu)',
    ], '1cfbcbaabf20'),
    'sky-scheduled': ([
        'r FTT (22, 4) e509ad901ea4 22580f1b2ddc a922de9a2180',
        'r FTT (11, 4) 844c107a6a46 52cd634ad1d6 a922de9a2180',
        's 0 plate0 backfill,row,stats b293eee4df6b',
        's 1 plate1 backfill,row,stats b293eee4df6b',
        's 2 plate2 backfill,row,stats b293eee4df6b',
        's 3 plate3 backfill,row,stats b293eee4df6b',
        's 4 plate4 backfill,row,stats b293eee4df6b',
        's 5 plate5 backfill,row,stats b293eee4df6b',
        's 6 plate6 backfill,row,stats b293eee4df6b',
        's 7 plate7 backfill,row,stats b293eee4df6b',
        's 8 plate8 backfill,row,stats b293eee4df6b',
        's 9 plate9 backfill,row,stats b293eee4df6b',
        'p 10 monitor 3c1ddfe7c11d',
        'r FTT (1, 4) 6b9354035a27 a284c69ab3fe ee557ea17300',
        's 10 ground backfill,row,stats 80cb68f23b92',
        'l (1/11) [plate0] 2 iter, 256 rays -> #s  (BVH=off, device=cpu)',
        'l (2/11) [plate1] 2 iter, 256 rays -> #s  (BVH=off, device=cpu)',
        'l (3/11) [plate2] 2 iter, 256 rays -> #s  (BVH=off, device=cpu)',
        'l (4/11) [plate3] 2 iter, 256 rays -> #s  (BVH=off, device=cpu)',
        'l (5/11) [plate4] 2 iter, 256 rays -> #s  (BVH=off, device=cpu)',
        'l (6/11) [plate5] 2 iter, 256 rays -> #s  (BVH=off, device=cpu)',
        'l (7/11) [plate6] 2 iter, 256 rays -> #s  (BVH=off, device=cpu)',
        'l (8/11) [plate7] 2 iter, 256 rays -> #s  (BVH=off, device=cpu)',
        'l (9/11) [plate8] 2 iter, 256 rays -> #s  (BVH=off, device=cpu)',
        'l (10/11) [plate9] 2 iter, 256 rays -> #s  (BVH=off, device=cpu)',
        'l (11/11) [ground] 3 iter, 4,056 rays -> #s  (BVH=off, device=cpu)',
    ], 'c022c16cac5d'),
    'sky-grouped': ([
        'd 0 0 1 FTT 0',
        'd 1 0 1 FTT 1',
        'd 2 0 1 FTT 2',
        'p 0 monitor 16bcaa43e886',
        'd 3 0 1 FTT 0',
        'p 1 monitor 16bcaa43e886',
        'd 4 0 1 FTT 1',
        'p 2 monitor 16bcaa43e886',
        'd 5 0 1 FTT 2',
        'p 3 monitor 16bcaa43e886',
        'd 6 0 1 FTT 0',
        'p 4 monitor 16bcaa43e886',
        'd 7 0 1 FTT 1',
        'p 5 monitor 16bcaa43e886',
        'd 8 0 1 FTT 2',
        'p 6 monitor 16bcaa43e886',
        'd 9 0 1 FTT 0',
        'p 7 monitor 16bcaa43e886',
        'd 10 0 1 FTT 1',
        'p 8 monitor 16bcaa43e886',
        'd 0 1 1 FTT 2',
        'p 9 monitor 16bcaa43e886',
        'd 1 1 1 FTT 0',
        'p 10 monitor 17f64b8df495',
        'd 2 1 1 FTT 1',
        's 0 plate0 backfill,row,stats b293eee4df6b',
        'd 3 1 1 FTT 2',
        's 1 plate1 backfill,row,stats b293eee4df6b',
        'd 4 1 1 FTT 0',
        's 2 plate2 backfill,row,stats b293eee4df6b',
        'd 5 1 1 FTT 1',
        's 3 plate3 backfill,row,stats b293eee4df6b',
        'd 6 1 1 FTT 2',
        's 4 plate4 backfill,row,stats b293eee4df6b',
        'd 7 1 1 FTT 0',
        's 5 plate5 backfill,row,stats b293eee4df6b',
        'd 8 1 1 FTT 1',
        's 6 plate6 backfill,row,stats b293eee4df6b',
        'd 9 1 1 FTT 2',
        's 7 plate7 backfill,row,stats b293eee4df6b',
        'd 10 1 1 FTT 0',
        's 8 plate8 backfill,row,stats b293eee4df6b',
        's 9 plate9 backfill,row,stats b293eee4df6b',
        'p 10 monitor 3c1ddfe7c11d',
        'd 10 2 1 FTT 0',
        's 10 ground backfill,row,stats 80cb68f23b92',
        'l (1/11) [plate0] 2 iter, 256 rays -> #s  (BVH=off, device=cpu)',
        'l (2/11) [plate1] 2 iter, 256 rays -> #s  (BVH=off, device=cpu)',
        'l (3/11) [plate2] 2 iter, 256 rays -> #s  (BVH=off, device=cpu)',
        'l (4/11) [plate3] 2 iter, 256 rays -> #s  (BVH=off, device=cpu)',
        'l (5/11) [plate4] 2 iter, 256 rays -> #s  (BVH=off, device=cpu)',
        'l (6/11) [plate5] 2 iter, 256 rays -> #s  (BVH=off, device=cpu)',
        'l (7/11) [plate6] 2 iter, 256 rays -> #s  (BVH=off, device=cpu)',
        'l (8/11) [plate7] 2 iter, 256 rays -> #s  (BVH=off, device=cpu)',
        'l (9/11) [plate8] 2 iter, 256 rays -> #s  (BVH=off, device=cpu)',
        'l (10/11) [plate9] 2 iter, 256 rays -> #s  (BVH=off, device=cpu)',
        'l (11/11) [ground] 3 iter, 4,056 rays -> #s  (BVH=off, device=cpu)',
    ], 'c022c16cac5d'),
    'workflow-scheduled': ([
        'r TTT (22, 4) e509ad901ea4 22580f1b2ddc b2aa8ed2fa15',
        'r TTT (11, 4) 844c107a6a46 52cd634ad1d6 b2aa8ed2fa15',
        'p 0 matrix,sky 9411443e3c7c',
        'p 1 matrix,sky 0d48f47ebad0',
        'p 2 matrix,sky 11d02b85d2bd',
        'p 3 matrix,sky d25ce2eb0a43',
        'p 4 matrix,sky 571fc09404a0',
        's 5 plate5 backfill,row,sky,stats 11d0cbb94203',
        's 6 plate6 backfill,row,sky,stats 435f707eb20f',
        's 7 plate7 backfill,row,sky,stats bd808d68d303',
        's 8 plate8 backfill,row,sky,stats 8974348f286b',
        'p 9 matrix,sky 1cd62b9b1af3',
        'p 10 matrix,sky 3f8aa266e5d2',
        'r TTT (72, 4) c7a2665aee4b d7f15b0f63bb 137e9d041c42',
        'p 0 matrix,sky 0b2534db5ff8',
        'p 1 matrix,sky 639219d44fb0',
        'p 2 matrix,sky deea09440e85',
        'p 3 matrix,sky 3cf3952ce0f4',
        'p 4 matrix,sky 3cf3952ce0f4',
        'p 9 matrix,sky 9fa2d810d2d9',
        's 10 ground backfill,row,sky,stats 0f1510148050',
        'r TTT (33, 4) 0373b379ef68 0ab3b1f04205 bf1fda447733',
        's 0 plate0 backfill,row,sky,stats f7604f4cca19',
        'p 1 matrix,sky 077cfbf62fc6',
        's 2 plate2 backfill,row,sky,stats 8785659fb50f',
        's 3 plate3 backfill,row,sky,stats 39b1000be1c1',
        's 4 plate4 backfill,row,sky,stats 810f721efddc',
        's 9 plate9 backfill,row,sky,stats 1336838e47e6',
        'r TTT (4, 4) 8f6cec11feb2 d0bd6fbcfc87 5964c4f8bae4',
        's 1 plate1 backfill,row,sky,stats ec1c7b39c2cc',
        'l (1/11) [plate0] traced 7 iter, 896 rays -> #s  (scene=7 iter, sky=2 iter, BVH=off, device=cpu)',
        'l (2/11) [plate1] traced 9 iter, 1,152 rays -> #s  (scene=9 iter, sky=2 iter, BVH=off, device=cpu)',
        'l (3/11) [plate2] traced 8 iter, 1,024 rays -> #s  (scene=8 iter, sky=2 iter, BVH=off, device=cpu)',
        'l (4/11) [plate3] traced 7 iter, 896 rays -> #s  (scene=7 iter, sky=2 iter, BVH=off, device=cpu)',
        'l (5/11) [plate4] traced 6 iter, 768 rays -> #s  (scene=6 iter, sky=2 iter, BVH=off, device=cpu)',
        'l (6/11) [plate5] traced 2 iter, 256 rays -> #s  (scene=2 iter, sky=2 iter, BVH=off, device=cpu)',
        'l (7/11) [plate6] traced 2 iter, 256 rays -> #s  (scene=2 iter, sky=2 iter, BVH=off, device=cpu)',
        'l (8/11) [plate7] traced 2 iter, 256 rays -> #s  (scene=2 iter, sky=2 iter, BVH=off, device=cpu)',
        'l (9/11) [plate8] traced 2 iter, 256 rays -> #s  (scene=2 iter, sky=2 iter, BVH=off, device=cpu)',
        'l (10/11) [plate9] traced 5 iter, 640 rays -> #s  (scene=5 iter, sky=2 iter, BVH=off, device=cpu)',
        'l (11/11) [ground] traced 3 iter, 4,056 rays -> #s  (scene=0 iter, sky=3 iter, BVH=off, device=cpu)',
    ], '6a0b338e4090'),
    'workflow-grouped': ([
        'd 0 0 1 TTT 0',
        'd 1 0 1 TTT 1',
        'd 2 0 1 TTT 2',
        'p 0 matrix,sky 917f38dea95e',
        'd 3 0 1 TTT 0',
        'p 1 matrix,sky d0156418daf8',
        'd 4 0 1 TTT 1',
        'p 2 matrix,sky be0ce6a4e21e',
        'd 5 0 1 TTT 2',
        'p 3 matrix,sky c7ade7cc4008',
        'd 6 0 1 TTT 0',
        'p 4 matrix,sky b8ab64f91542',
        'd 7 0 1 TTT 1',
        'p 5 matrix,sky 87b8770517f4',
        'd 8 0 1 TTT 2',
        'p 6 matrix,sky c7ade7cc4008',
        'd 9 0 1 TTT 0',
        'p 7 matrix,sky 87b8770517f4',
        'd 10 0 1 FTT 1',
        'p 8 matrix,sky 9840f3d2629d',
        'd 0 1 1 TTT 2',
        'p 9 matrix,sky b6813d2d8b8e',
        'd 1 1 1 TTT 0',
        'p 10 matrix,sky afdab031c5be',
        'd 2 1 1 TTT 1',
        'p 0 matrix,sky 9411443e3c7c',
        'd 3 1 1 TTT 2',
        'p 1 matrix,sky 0d48f47ebad0',
        'd 4 1 1 TTT 0',
        'p 2 matrix,sky 11d02b85d2bd',
        'd 5 1 1 TTT 1',
        'p 3 matrix,sky d25ce2eb0a43',
        'd 6 1 1 TTT 2',
        'p 4 matrix,sky 571fc09404a0',
        'd 7 1 1 TTT 0',
        's 5 plate5 backfill,row,sky,stats 11d0cbb94203',
        'd 8 1 1 TTT 1',
        's 6 plate6 backfill,row,sky,stats 435f707eb20f',
        'd 9 1 1 TTT 2',
        's 7 plate7 backfill,row,sky,stats bd808d68d303',
        'd 10 1 1 FTT 0',
        's 8 plate8 backfill,row,sky,stats 8974348f286b',
        'd 0 2 16 TFT 1',
        'p 9 matrix,sky 1cd62b9b1af3',
        'd 1 2 1 TFT 2',
        'p 10 matrix,sky 3f8aa266e5d2',
        'd 2 2 16 TFT 0',
        's 0 plate0 backfill,row,sky,stats f7604f4cca19',
        'd 3 2 16 TFT 1',
        'p 1 matrix,sky 639219d44fb0',
        'd 4 2 4 TFT 2',
        's 2 plate2 backfill,row,sky,stats 8785659fb50f',
        'd 9 2 4 TFT 0',
        's 3 plate3 backfill,row,sky,stats 39b1000be1c1',
        'd 10 2 1 FTT 1',
        's 4 plate4 backfill,row,sky,stats 810f721efddc',
        'd 1 3 4 TFT 2',
        's 9 plate9 backfill,row,sky,stats 1336838e47e6',
        's 10 ground backfill,row,sky,stats 0f1510148050',
        'p 1 matrix,sky de435e881b22',
        'd 1 7 4 TFT 0',
        's 1 plate1 backfill,row,sky,stats ec1c7b39c2cc',
        'l (1/11) [plate0] traced 7 iter, 896 rays -> #s  (scene=7 iter, sky=2 iter, BVH=off, device=cpu)',
        'l (2/11) [plate1] traced 9 iter, 1,152 rays -> #s  (scene=9 iter, sky=2 iter, BVH=off, device=cpu)',
        'l (3/11) [plate2] traced 8 iter, 1,024 rays -> #s  (scene=8 iter, sky=2 iter, BVH=off, device=cpu)',
        'l (4/11) [plate3] traced 7 iter, 896 rays -> #s  (scene=7 iter, sky=2 iter, BVH=off, device=cpu)',
        'l (5/11) [plate4] traced 6 iter, 768 rays -> #s  (scene=6 iter, sky=2 iter, BVH=off, device=cpu)',
        'l (6/11) [plate5] traced 2 iter, 256 rays -> #s  (scene=2 iter, sky=2 iter, BVH=off, device=cpu)',
        'l (7/11) [plate6] traced 2 iter, 256 rays -> #s  (scene=2 iter, sky=2 iter, BVH=off, device=cpu)',
        'l (8/11) [plate7] traced 2 iter, 256 rays -> #s  (scene=2 iter, sky=2 iter, BVH=off, device=cpu)',
        'l (9/11) [plate8] traced 2 iter, 256 rays -> #s  (scene=2 iter, sky=2 iter, BVH=off, device=cpu)',
        'l (10/11) [plate9] traced 5 iter, 640 rays -> #s  (scene=5 iter, sky=2 iter, BVH=off, device=cpu)',
        'l (11/11) [ground] traced 3 iter, 4,056 rays -> #s  (scene=0 iter, sky=3 iter, BVH=off, device=cpu)',
    ], '6a0b338e4090'),
    'workflow-resumed': ([
        'd 0 0 1 TTT 0',
        'd 1 0 1 TTT 1',
        'd 2 0 1 TTT 2',
        'p 0 matrix,sky 917f38dea95e',
        'd 3 0 1 TTT 0',
        'p 1 matrix,sky d0156418daf8',
        'd 4 0 1 TTT 1',
        'p 2 matrix,sky be0ce6a4e21e',
        'd 5 0 1 TTT 2',
        'p 3 matrix,sky c7ade7cc4008',
        'd 6 0 1 TTT 0',
        'p 4 matrix,sky b8ab64f91542',
        'd 7 0 1 TTT 1',
        'p 5 matrix,sky 87b8770517f4',
        'd 8 0 1 TTT 2',
        'p 6 matrix,sky c7ade7cc4008',
        'd 9 0 1 TTT 0',
        'p 7 matrix,sky 87b8770517f4',
        'd 10 0 1 FTT 1',
        'p 8 matrix,sky 9840f3d2629d',
        'd 0 1 1 TTT 2',
        'p 9 matrix,sky b6813d2d8b8e',
        'd 1 1 1 TTT 0',
        'p 10 matrix,sky afdab031c5be',
        'd 2 1 1 TTT 1',
        'p 0 matrix,sky 9411443e3c7c',
        'd 3 1 1 TTT 2',
        'p 1 matrix,sky 0d48f47ebad0',
        'd 4 1 1 TTT 0',
        'p 2 matrix,sky 11d02b85d2bd',
        'd 5 1 1 TTT 1',
        'p 3 matrix,sky d25ce2eb0a43',
        'd 6 1 1 TTT 2',
        'p 4 matrix,sky 571fc09404a0',
        'd 7 1 1 TTT 0',
        'resume',
        'l (1/11) [plate0] resuming from iteration 2',
        'l (2/11) [plate1] resuming from iteration 2',
        'l (3/11) [plate2] resuming from iteration 2',
        'l (4/11) [plate3] resuming from iteration 2',
        'l (5/11) [plate4] resuming from iteration 2',
        'l (6/11) [plate5] resuming from iteration 1',
        'l (7/11) [plate6] resuming from iteration 1',
        'l (8/11) [plate7] resuming from iteration 1',
        'l (9/11) [plate8] resuming from iteration 1',
        'l (10/11) [plate9] resuming from iteration 1',
        'l (11/11) [ground] resuming from iteration 1',
        'd 0 2 16 TFT 0',
        'd 1 2 1 TFT 1',
        'd 2 2 16 TFT 2',
        's 0 plate0 backfill,row,sky,stats f7604f4cca19',
        'd 3 2 16 TFT 0',
        'p 1 matrix,sky 639219d44fb0',
        'd 4 2 4 TFT 1',
        's 2 plate2 backfill,row,sky,stats 8785659fb50f',
        'd 5 1 1 TTT 2',
        's 3 plate3 backfill,row,sky,stats 39b1000be1c1',
        'd 6 1 1 TTT 0',
        's 4 plate4 backfill,row,sky,stats 810f721efddc',
        'd 7 1 1 TTT 1',
        's 5 plate5 backfill,row,sky,stats 11d0cbb94203',
        'd 8 1 1 TTT 2',
        's 6 plate6 backfill,row,sky,stats 435f707eb20f',
        'd 9 1 1 TTT 0',
        's 7 plate7 backfill,row,sky,stats bd808d68d303',
        'd 10 1 1 FTT 1',
        's 8 plate8 backfill,row,sky,stats 8974348f286b',
        'd 1 3 4 TFT 2',
        'p 9 matrix,sky 1cd62b9b1af3',
        'd 9 2 4 TFT 0',
        'p 10 matrix,sky 3f8aa266e5d2',
        'd 10 2 1 FTT 1',
        'p 1 matrix,sky de435e881b22',
        'd 1 7 4 TFT 2',
        's 9 plate9 backfill,row,sky,stats 1336838e47e6',
        's 10 ground backfill,row,sky,stats 0f1510148050',
        's 1 plate1 backfill,row,sky,stats ec1c7b39c2cc',
        'l (1/11) [plate0] traced 7 iter, 896 rays -> #s  (scene=7 iter, sky=2 iter, BVH=off, device=cpu)',
        'l (2/11) [plate1] traced 9 iter, 1,152 rays -> #s  (scene=9 iter, sky=2 iter, BVH=off, device=cpu)',
        'l (3/11) [plate2] traced 8 iter, 1,024 rays -> #s  (scene=8 iter, sky=2 iter, BVH=off, device=cpu)',
        'l (4/11) [plate3] traced 7 iter, 896 rays -> #s  (scene=7 iter, sky=2 iter, BVH=off, device=cpu)',
        'l (5/11) [plate4] traced 6 iter, 768 rays -> #s  (scene=6 iter, sky=2 iter, BVH=off, device=cpu)',
        'l (6/11) [plate5] traced 2 iter, 256 rays -> #s  (scene=2 iter, sky=2 iter, BVH=off, device=cpu)',
        'l (7/11) [plate6] traced 2 iter, 256 rays -> #s  (scene=2 iter, sky=2 iter, BVH=off, device=cpu)',
        'l (8/11) [plate7] traced 2 iter, 256 rays -> #s  (scene=2 iter, sky=2 iter, BVH=off, device=cpu)',
        'l (9/11) [plate8] traced 2 iter, 256 rays -> #s  (scene=2 iter, sky=2 iter, BVH=off, device=cpu)',
        'l (10/11) [plate9] traced 5 iter, 640 rays -> #s  (scene=5 iter, sky=2 iter, BVH=off, device=cpu)',
        'l (11/11) [ground] traced 3 iter, 4,056 rays -> #s  (scene=0 iter, sky=3 iter, BVH=off, device=cpu)',
    ], '6a0b338e4090'),
}


if __name__ == "__main__":
    torch.set_num_threads(1)
    recorded = {}
    for case in CASES:
        with tempfile.TemporaryDirectory() as tmp, pytest.MonkeyPatch.context() as mp:
            recorded[case] = _record(case, tmp, mp)
    sys.stdout.write("EXPECTED = {\n")
    for case, (events, result) in recorded.items():
        sys.stdout.write(f"    {case!r}: ([\n")
        for e in events:
            sys.stdout.write(f"        {e!r},\n")
        sys.stdout.write(f"    ], {result!r}),\n")
    sys.stdout.write("}\n")
