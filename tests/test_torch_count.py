"""The exact per-row count: its plain version with the ``valid`` flags the
kernel takes, against the route it replaces and the JAX package's count.

After a coherence sort the real rays of a row no longer lead it, so the
gated dispatches used to mask the codes of padded rays to -1
(``torch.where``) and count every ray (``torch.full_like``) before each
count. The kernel now takes the (rows, L) ``valid`` flags itself, and
``ops/trace._count_rows`` hands them over with neither op. All comparisons
are exact: integer counts.

The JAX package counts inline in ``scheduled_trace_pallas`` /
``chunk_body_pallas`` (``raystrack_tpu/ops/trace.py`` lines 862-870): codes
of rays that are not valid become -1, then one ``jnp.sum(codes == target)``
per code under ``jax.lax.map``; ``_jax_counts`` runs those lines as they
stand on the same NumPy codes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import raystrack_tpu_torch.ops.trace as ttrace
from raystrack_tpu_torch.ops.count_cuda import count_bins, count_codes, count_codes_reference


def _jax_counts(codes, ray_valid, n_surf):
    """``raystrack_tpu/ops/trace.py:862-870`` on NumPy inputs: (counts_f,
    counts_b) (rows, n_surf)."""
    codes = jnp.where(jnp.asarray(ray_valid), jnp.asarray(codes), -1)

    def count_code(target):
        return jnp.sum(codes == target, axis=1, dtype=jnp.int32)

    targets_b = jnp.arange(n_surf, dtype=jnp.int32) * 2
    counts_b = jax.lax.map(count_code, targets_b).T
    counts_f = jax.lax.map(count_code, targets_b + 1).T
    return np.asarray(counts_f), np.asarray(counts_b)


def _inputs(rows, length, n_surf, seed):
    """Codes with misses, out-of-range codes and hot bins; per row a random
    permutation of valid flags (a sorted row's padded rays lie anywhere) and
    the n_valid of the same rows before the sort."""
    rng = np.random.default_rng(seed)
    codes = rng.integers(-3, 2 * n_surf + 3, size=(rows, length)).astype(np.int32)
    codes[:, : length // 3] = rng.integers(0, 4, size=(rows, length // 3))
    n_valid = rng.integers(0, length + 1, size=rows).astype(np.int32)
    n_valid[0] = length
    valid = np.stack([rng.permutation(np.arange(length) < n) for n in n_valid])
    return codes, n_valid, valid


CASES = [(6, 2048, 11), (2, 8192, 3), (3, 300, 1)]
IDS = ["round_rows", "chunk_rows", "one_surface"]


@pytest.mark.parametrize("rows,length,n_surf", CASES, ids=IDS)
def test_valid_flags_equal_the_where_and_full_like_route(rows, length, n_surf):
    """count_codes_reference(codes, None, n_surf, valid) == the route it
    replaces: codes masked with torch.where, n_valid = L by full_like."""
    codes, n_valid, valid = _inputs(rows, length, n_surf, seed=rows + length)
    c, nv, v = torch.from_numpy(codes), torch.from_numpy(n_valid), torch.from_numpy(valid)
    want = count_codes_reference(torch.where(v, c, -1), torch.full_like(nv, length), n_surf)
    got = count_codes_reference(c, None, n_surf, v)
    assert torch.equal(got, want)
    assert int(got.sum()) > 0


@pytest.mark.parametrize("rows,length,n_surf", CASES, ids=IDS)
def test_count_codes_equals_the_jax_package_count(rows, length, n_surf):
    """The same NumPy codes through count_codes (valid flags; n_valid;
    both) and through the JAX package's count lines: equal."""
    codes, n_valid, valid = _inputs(rows, length, n_surf, seed=3 * rows + length)
    c, nv, v = torch.from_numpy(codes), torch.from_numpy(n_valid), torch.from_numpy(valid)
    leading = np.arange(length)[None, :] < n_valid[:, None]
    for kwargs, ray_valid in (
        (dict(n_valid=None, valid=v), valid),
        (dict(n_valid=nv, valid=None), leading),
        (dict(n_valid=nv, valid=v), valid & leading),
        (dict(n_valid=None, valid=None), np.ones_like(valid)),
    ):
        f, b = count_codes(c, kwargs["n_valid"], n_surf, valid=kwargs["valid"])
        jf, jb = _jax_counts(codes, ray_valid, n_surf)
        np.testing.assert_array_equal(f.numpy(), jf)
        np.testing.assert_array_equal(b.numpy(), jb)
    assert count_bins.launches == 0


@pytest.mark.parametrize("gated", [True, False], ids=["sorted", "leading"])
def test_count_rows_hands_the_flags_to_the_count(monkeypatch, gated):
    """_count_rows runs no tensor op of its own: the codes reach count_codes
    as they are, with the valid flags (and no n_valid) after a sort, with
    n_valid otherwise; the counts equal the where + full_like route."""
    rows, length, n_surf = 4, 1024, 5
    codes, n_valid, valid = _inputs(rows, length, n_surf, seed=11)
    c, nv, v = torch.from_numpy(codes), torch.from_numpy(n_valid), torch.from_numpy(valid)
    calls = []

    def spy(*args, **kwargs):  # records; the count runs after the patches are gone
        calls.append((args, kwargs))
        return None, None

    def no_op(*args, **kwargs):
        raise AssertionError("_count_rows ran a tensor op")

    monkeypatch.setattr(ttrace, "count_codes", spy)
    monkeypatch.setattr(torch, "where", no_op)
    monkeypatch.setattr(torch, "full_like", no_op)
    ttrace._count_rows(c, v if gated else None, nv, n_surf)
    monkeypatch.undo()
    (args, kwargs), = calls
    f, b = count_codes(*args, **kwargs)
    assert args[0] is c and args[2] == n_surf
    if gated:
        assert args[1] is None and kwargs["valid"] is v
        want = count_codes_reference(torch.where(v, c, -1), torch.full_like(nv, length), n_surf)
    else:
        assert args[1] is nv and kwargs.get("valid") is None
        want = count_codes_reference(c, nv, n_surf)
    want = want.view(rows, n_surf, 2)
    assert torch.equal(f, want[:, :, 1]) and torch.equal(b, want[:, :, 0])


def test_count_codes_checks_the_valid_flags():
    codes = torch.zeros((2, 8), dtype=torch.int32)
    with pytest.raises(TypeError, match="valid"):
        count_codes(codes, None, 1, valid=torch.ones((2, 8), dtype=torch.int32))
    with pytest.raises(ValueError, match="valid"):
        count_codes(codes, None, 1, valid=torch.ones((2, 7), dtype=torch.bool))
    with pytest.raises(ValueError, match="contiguous"):
        count_codes(codes, None, 1, valid=torch.ones((8, 2), dtype=torch.bool).T)
    with pytest.raises(TypeError, match="n_valid"):
        count_codes(codes, [8, 8], 1)
