"""Port parity: the Halton device builder, the disk cache and the dims cache.

Modelled on ``tests/test_halton.py``. The device builder runs here on a CPU
device: the same torch code a card runs, so its tables must equal the JAX
package's host tables bitwise, chunk seams included. Tables either package
writes to ``RAYSTRACK_TPU_TABLE_CACHE`` are read by the other. Packs and flat
tables built from device tables equal the host-built ones. The card's own
bitwise checks are in ``tests/test_torch_card.py`` and ``chip_smoke.py``
phase 21.
"""
import numpy as np
import pytest
import torch

import raystrack_tpu.ops.halton as jhalton
import raystrack_tpu_torch.ops.halton as thalton
import raystrack_tpu_torch.prepared as tprep
from raystrack_tpu_torch import config as tconfig

CPU = torch.device("cpu")
FIELDS = ("u_cell", "v_cell", "h_tri", "h_u", "h_v", "h_r1", "h_r2")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: beside other test workers, more threads only
    contend for the same cores."""
    n_threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n_threads)


@pytest.fixture(autouse=True)
def _clean_caches(monkeypatch):
    """No table cache directory, the device builder on auto, empty dims
    caches before and after each test."""
    monkeypatch.delenv(tconfig.TABLE_CACHE_ENV, raising=False)
    monkeypatch.delenv(tconfig.DEVICE_HALTON_ENV, raising=False)
    thalton.cached_halton_dims.cache_clear()
    thalton.cached_halton.cache_clear()
    yield
    thalton.cached_halton_dims.cache_clear()
    thalton.cached_halton.cache_clear()


@pytest.fixture
def cpu_as_card(monkeypatch):
    """Let the CPU stand in for a card: tables asked for on it take the
    device builder, as they would on a CUDA device."""
    monkeypatch.setattr(thalton, "_on_card", lambda device: device is not None)


def _jax_table(length, base):
    return jhalton.radical_inverse(np.arange(1, length + 1, dtype=np.int64), base).astype(
        np.float32)


@pytest.mark.parametrize("base", [5, 2, 3, 7, 11])
def test_device_builder_bitwise_equals_jax_host_tables(base):
    # 50,000 entries, and a length ending on a digit-count boundary
    for length in (50_000, base**6, base**6 + 1):
        table = thalton._halton_dim_device(length, base, CPU)
        assert table.dtype == torch.float32 and table.device == CPU
        np.testing.assert_array_equal(table.numpy(), _jax_table(length, base))


@pytest.mark.parametrize("base,length", [(2, 40_000), (3, 4096 * 2 + 3_000), (7, 4096),
                                         (11, 4097)])
def test_device_builder_chunk_stitching(monkeypatch, base, length):
    """Tables spanning several chunks, with a ragged tail, one exact chunk
    and one entry past it, equal the host build bitwise."""
    monkeypatch.setattr(thalton, "DEVICE_CHUNK", 4096)
    table = thalton._halton_dim_device(length, base, CPU)
    assert table.shape == (length,)
    np.testing.assert_array_equal(table.numpy(), _jax_table(length, base))


@pytest.mark.parametrize("g,chunk", [(5, None), (64, None), (70, 1024), (91, 4096)])
def test_device_grid_bitwise_equals_jax_grid(monkeypatch, g, chunk):
    """The stratified (u, v) grid built on a device, across chunk seams
    where ``chunk`` is set, is the JAX package's host grid bit for bit."""
    if chunk is not None:
        monkeypatch.setattr(thalton, "DEVICE_CHUNK", chunk)
    u, v = thalton._halton_grid_device(g, CPU)
    want_u, want_v = jhalton.cached_halton(g)
    assert u.dtype == v.dtype == torch.float32 and u.shape == (g * g,)
    np.testing.assert_array_equal(u.numpy(), want_u)
    np.testing.assert_array_equal(v.numpy(), want_v)


def test_grid_cache_is_keyed_by_device(monkeypatch, cpu_as_card):
    """Grids of ``config.DEVICE_MIN_LENGTH`` cells or more asked for on a
    card are built there, in a 2-entry cache of their own; the host grid
    stays numpy; cache_clear clears both."""
    monkeypatch.setattr(tconfig, "DEVICE_MIN_LENGTH", 1_000)
    thalton.cached_halton.cache_clear()
    host = thalton.cached_halton(40)
    small = thalton.cached_halton(20, CPU)  # 400 cells: under the threshold
    assert all(isinstance(t, np.ndarray) for t in host + small)
    assert small is thalton.cached_halton(20)
    on_cpu = thalton.cached_halton(40, CPU)
    assert all(isinstance(t, torch.Tensor) for t in on_cpu)
    for a, b in zip(host, on_cpu):
        np.testing.assert_array_equal(a, b.numpy())
    for g in (41, 42):
        thalton.cached_halton(g, CPU)
    assert thalton._cached_grid_device.cache_info().currsize == 2
    assert thalton._cached_grid_device.cache_info().maxsize == 2
    assert thalton._cached_grid_host.cache_info().maxsize == 128
    thalton.cached_halton.cache_clear()
    assert thalton._cached_grid_host.cache_info().currsize == 0
    assert thalton._cached_grid_device.cache_info().currsize == 0


def test_table_written_by_jax_is_read_by_the_port(monkeypatch, tmp_path):
    monkeypatch.setenv(tconfig.TABLE_CACHE_ENV, str(tmp_path))
    monkeypatch.setattr(jhalton, "_DISK_CACHE_MIN_LENGTH", 1_000)
    monkeypatch.setattr(tconfig, "DISK_CACHE_MIN_LENGTH", 1_000)
    written = jhalton._halton_dim(5_000, 3)
    assert (tmp_path / "halton_b3_n5000.npy").exists()

    def no_build(*args):
        raise AssertionError("the port rebuilt a table the JAX package cached")

    monkeypatch.setattr(thalton, "_halton_dim_host", no_build)
    monkeypatch.setattr(thalton, "_halton_dim_device", no_build)
    read = thalton._halton_dim(5_000, 3)
    assert isinstance(read, np.ndarray)
    np.testing.assert_array_equal(read, written)


def test_table_written_by_the_port_is_read_by_jax(monkeypatch, tmp_path):
    monkeypatch.setenv(tconfig.TABLE_CACHE_ENV, str(tmp_path))
    monkeypatch.setattr(jhalton, "_DISK_CACHE_MIN_LENGTH", 1_000)
    monkeypatch.setattr(tconfig, "DISK_CACHE_MIN_LENGTH", 1_000)
    written = thalton._halton_dim(5_000, 5)
    assert sorted(p.name for p in tmp_path.iterdir()) == ["halton_b5_n5000.npy"]

    def no_build(*args):
        raise AssertionError("the JAX package rebuilt a table the port cached")

    monkeypatch.setattr(jhalton, "radical_inverse", no_build)
    np.testing.assert_array_equal(jhalton._halton_dim(5_000, 5), written)


def test_device_built_table_is_published_from_one_copy(monkeypatch, tmp_path, cpu_as_card):
    """With the disk cache on, a device-built table stays a tensor and is
    written to disk, where the JAX package reads it."""
    monkeypatch.setenv(tconfig.TABLE_CACHE_ENV, str(tmp_path))
    monkeypatch.setenv(tconfig.DEVICE_HALTON_ENV, "1")
    monkeypatch.setattr(tconfig, "DISK_CACHE_MIN_LENGTH", 1_000)
    monkeypatch.setattr(jhalton, "_DISK_CACHE_MIN_LENGTH", 1_000)
    table = thalton._halton_dim(3_000, 7, CPU)
    assert isinstance(table, torch.Tensor)
    on_disk = np.load(tmp_path / "halton_b7_n3000.npy")
    np.testing.assert_array_equal(on_disk, table.numpy())
    np.testing.assert_array_equal(jhalton._halton_dim(3_000, 7), on_disk)
    assert not list(tmp_path.glob("*.tmp.npy"))


def test_tables_below_the_disk_threshold_never_touch_disk(monkeypatch, tmp_path, cpu_as_card):
    monkeypatch.setenv(tconfig.TABLE_CACHE_ENV, str(tmp_path))
    monkeypatch.setenv(tconfig.DEVICE_HALTON_ENV, "1")
    assert tconfig.DISK_CACHE_MIN_LENGTH == jhalton._DISK_CACHE_MIN_LENGTH == 4_000_000
    thalton._halton_dim(50_000, 2)
    thalton._halton_dim(50_000, 3, CPU)
    thalton.cached_halton_dims(70_000)
    assert not list(tmp_path.iterdir())


def test_a_foreign_file_of_the_wrong_shape_is_rebuilt(monkeypatch, tmp_path):
    monkeypatch.setenv(tconfig.TABLE_CACHE_ENV, str(tmp_path))
    monkeypatch.setattr(tconfig, "DISK_CACHE_MIN_LENGTH", 1_000)
    np.save(tmp_path / "halton_b2_n2000.npy", np.zeros(1999, np.float32))
    table = thalton._halton_dim(2_000, 2)
    np.testing.assert_array_equal(table, _jax_table(2_000, 2))
    np.testing.assert_array_equal(np.load(tmp_path / "halton_b2_n2000.npy"), table)


def test_dims_cache_partition(monkeypatch):
    """Lengths at or above the device threshold go to the 2-entry big
    cache; cache_clear clears both, as the JAX package's does."""
    monkeypatch.setattr(tconfig, "DEVICE_MIN_LENGTH", 1_000)
    thalton.cached_halton_dims(100)
    for n in (1_000, 2_000, 3_000):
        thalton.cached_halton_dims(n)
    small = thalton._cached_dims_small.cache_info()
    big = thalton._cached_dims_big.cache_info()
    assert small.currsize == 1 and small.maxsize == 128
    assert big.currsize == 2 and big.maxsize == 2
    assert (small.maxsize, big.maxsize) == (
        jhalton._cached_dims_small.cache_info().maxsize,
        jhalton._cached_dims_big.cache_info().maxsize)
    thalton.cached_halton_dims.cache_clear()
    assert thalton._cached_dims_small.cache_info().currsize == 0
    assert thalton._cached_dims_big.cache_info().currsize == 0


def test_device_tables_are_keyed_by_device(monkeypatch, cpu_as_card):
    """A table set built for one device is never handed to another, nor
    to a host caller; the host set stays numpy."""
    monkeypatch.setattr(tconfig, "DEVICE_MIN_LENGTH", 1_000)
    host = thalton.cached_halton_dims(1_500)
    on_cpu = thalton.cached_halton_dims(1_500, CPU)
    on_meta = thalton.cached_halton_dims(1_500, torch.device("meta"))
    assert all(isinstance(t, np.ndarray) for t in host)
    assert all(isinstance(t, torch.Tensor) and t.device == CPU for t in on_cpu)
    assert all(t.device.type == "meta" and t.shape == (1_500,) for t in on_meta)
    assert thalton.cached_halton_dims(1_500, CPU) is on_cpu
    for a, b in zip(host, on_cpu):
        np.testing.assert_array_equal(a, b.numpy())
    assert thalton._cached_dims_big.cache_info().currsize == 2  # the 2 most recent


def test_the_cpu_builds_on_the_host_by_design(monkeypatch):
    """The CPU is the one device that takes the host build, at any length
    and whatever RAYSTRACK_TPU_DEVICE_HALTON says."""
    monkeypatch.setenv(tconfig.DEVICE_HALTON_ENV, "1")
    dims = thalton.cached_halton_dims(3_000, CPU)
    assert all(isinstance(t, np.ndarray) for t in dims)
    assert dims is thalton.cached_halton_dims(3_000)


@pytest.mark.parametrize("raw,below,above", [
    (None, False, True), ("auto", False, True), ("AUTO", False, True),
    ("0", False, False), ("off", False, False), ("False", False, False),
    ("1", True, True), ("on", True, True), ("TRUE", True, True),
])
def test_device_halton_variable(monkeypatch, raw, below, above):
    if raw is not None:
        monkeypatch.setenv("RAYSTRACK_TPU_DEVICE_HALTON", raw)
    assert tconfig.DEVICE_HALTON_ENV == "RAYSTRACK_TPU_DEVICE_HALTON"
    n = tconfig.DEVICE_MIN_LENGTH
    assert n == jhalton._DEVICE_MIN_LENGTH
    assert thalton._device_halton_enabled(n - 1) is below
    assert thalton._device_halton_enabled(n) is above
    assert jhalton._device_halton_enabled(n - 1) is below
    assert jhalton._device_halton_enabled(n) is above


def _plate(scale=1.0, z=0.0):
    V = np.array([[0, 0, 0], [1, 0, 0], [1, 1, 0], [0, 1, 0]], np.float32)
    F = np.array([[0, 1, 2], [0, 2, 3]], np.int32)
    return V * np.float32(scale) + np.float32([0, 0, z]), F


def test_cuda_bound_pack_never_builds_a_host_table(monkeypatch):
    """A pack for a CUDA device takes every per-ray table and its grid from
    the device builders (stubbed here to build on the CPU) and builds no
    host table: no host build, no radical inverse on the host."""
    monkeypatch.setattr(tconfig, "DEVICE_MIN_LENGTH", 50)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(tprep, "_put", lambda a, device: torch.from_numpy(
        np.ascontiguousarray(a)))
    built = []
    real_device = thalton._halton_dim_device

    def device_stub(length, base, device):
        assert torch.device(device).type == "cuda"
        built.append((length, base))
        return real_device(length, base, CPU)

    real_grid = thalton._halton_grid_device

    def grid_stub(g, device):
        assert torch.device(device).type == "cuda"
        built.append((g * g, "grid"))
        return real_grid(g, CPU)

    real_inverse = thalton.radical_inverse
    inverse_sizes = []

    def inverse_spy(indices, base):
        inverse_sizes.append(np.asarray(indices).size)
        return real_inverse(indices, base)

    def no_host(*args):
        raise AssertionError("the host builder ran for a CUDA-bound pack")

    V, F = _plate()
    (em,) = tprep.prepare_emitters([("plate", V, F)], samples=64, rays=64, flip_faces=False)
    n = em.n_cells * em.rays
    assert n >= 1_000
    monkeypatch.setattr(thalton, "_halton_dim_device", device_stub)
    monkeypatch.setattr(thalton, "_halton_grid_device", grid_stub)
    monkeypatch.setattr(thalton, "_halton_dim_host", no_host)
    monkeypatch.setattr(thalton, "_halton_grid_host", no_host)
    monkeypatch.setattr(thalton, "radical_inverse", inverse_spy)
    thalton.cached_halton.cache_clear()
    pack = tprep.pack_emitter(em, 64, device=torch.device("cuda"))
    assert sorted(built, key=str) == sorted(
        [(n, b) for b in thalton.BASES] + [(em.n_cells, "grid")], key=str)
    assert inverse_sizes == []
    monkeypatch.undo()
    thalton.cached_halton_dims.cache_clear()
    thalton.cached_halton.cache_clear()
    want = tprep.pack_emitter(em, 64, device=CPU)
    for field in FIELDS:
        assert torch.equal(getattr(pack, field), getattr(want, field)), field


def test_pack_emitter_from_device_tables_equals_host(monkeypatch, cpu_as_card):
    monkeypatch.setattr(tconfig, "DEVICE_MIN_LENGTH", 1_000)
    V, F = _plate()
    (em,) = tprep.prepare_emitters([("plate", V, F)], samples=48, rays=64, flip_faces=False)
    assert isinstance(em.dims_on(CPU)[0], torch.Tensor)
    assert isinstance(em.halton_tri, np.ndarray)  # the host properties stay host
    dev_pack = tprep.pack_emitter(em, 64, align=4096, device=CPU)

    monkeypatch.setenv(tconfig.DEVICE_HALTON_ENV, "0")
    assert isinstance(em.dims_on(CPU)[0], np.ndarray)
    host_pack = tprep.pack_emitter(em, 64, align=4096, device=CPU)
    assert dev_pack.n_rays_pad == host_pack.n_rays_pad > em.n_cells * 64
    for field in FIELDS + ("cdf", "tri_a", "plane_vec"):
        a, b = getattr(dev_pack, field), getattr(host_pack, field)
        assert a.dtype == b.dtype and torch.equal(a, b), field


def test_flat_tables_from_device_tables_equal_host(monkeypatch, cpu_as_card):
    """A mixed scene (one emitter past the device threshold, one under it):
    the flat tables concatenate on the device and equal the host path's."""
    monkeypatch.setattr(tconfig, "DEVICE_MIN_LENGTH", 1_000)
    V, F = _plate()
    V2, _ = _plate(0.125, 1.0)
    meshes = [("big", V, F), ("small", V2, F)]
    ps_dev = tprep.PreparedSolver(meshes)
    flat_dev, geom_dev, off_dev, pad_dev = ps_dev.get_flat_tables(
        samples=64, rays=32, flip_faces=False, device=CPU)
    big, small = ps_dev.get_emitters(samples=64, rays=32, flip_faces=False)
    assert isinstance(big.dims_on(CPU)[0], torch.Tensor)
    assert isinstance(small.dims_on(CPU)[0], np.ndarray)

    monkeypatch.setenv(tconfig.DEVICE_HALTON_ENV, "0")
    ps_host = tprep.PreparedSolver(meshes)
    flat_host, geom_host, off_host, pad_host = ps_host.get_flat_tables(
        samples=64, rays=32, flip_faces=False, device=CPU)
    np.testing.assert_array_equal(off_dev, off_host)
    np.testing.assert_array_equal(pad_dev, pad_host)
    for a, b in zip(flat_dev + geom_dev, flat_host + geom_host):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_flat_tables_equal_the_jax_package_with_device_tables(monkeypatch, cpu_as_card):
    """Against the JAX package's host-built flat tables, bitwise."""
    import raystrack_tpu.prepared as jprep

    monkeypatch.setattr(tconfig, "DEVICE_MIN_LENGTH", 1_000)
    V, F = _plate()
    meshes = [("big", V, F), ("top", *_plate(1.0, 1.0))]
    flat, _, offsets, _ = tprep.PreparedSolver(meshes).get_flat_tables(
        samples=64, rays=32, flip_faces=False, device=CPU)
    want, _, want_offsets, _ = jprep.PreparedSolver(meshes).get_flat_tables(
        samples=64, rays=32, flip_faces=False)
    np.testing.assert_array_equal(offsets, want_offsets)
    for a, b in zip(flat, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
