"""Runtime policy: compile-cache location, psutil-free memory probe, and
shard_map bodies under the default varying-axes checks."""

import os
import subprocess
import sys

import numpy as np
import pytest

import jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = ("import jax, medicalimageanalysis_tpu.ops; "
          "print(jax.config.jax_compilation_cache_dir)")


def _cache_dir_in_child(env_update, drop=()):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    for k in drop:
        env.pop(k, None)
    env.update(env_update)
    r = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    return r.stdout.strip().splitlines()[-1]


def test_cache_dir_honours_env_var(tmp_path):
    got = _cache_dir_in_child(
        {"JAX_COMPILATION_CACHE_DIR": str(tmp_path / "cc")})
    assert got == str(tmp_path / "cc")


def test_cache_dir_default_is_checkout_path():
    from medicalimageanalysis_tpu.runtime import DEFAULT_CACHE_DIR
    assert DEFAULT_CACHE_DIR == os.path.join(ROOT, ".jax_cache")
    got = _cache_dir_in_child({}, drop=("JAX_COMPILATION_CACHE_DIR",))
    assert got == DEFAULT_CACHE_DIR


def test_reader_does_not_import_psutil():
    """read_dicoms' module imports without psutil installed."""
    code = ("import sys; sys.modules['psutil'] = None; "
            "import medicalimageanalysis_tpu.reader as r; "
            "print(r._available_memory_bytes() > 0)")
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120,
                       env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "True"


def test_check_memory_without_proc_meminfo(tmp_path, monkeypatch):
    """Where /proc/meminfo cannot be read, the sysconf page count
    answers instead."""
    import builtins

    import medicalimageanalysis_tpu as mia
    import medicalimageanalysis_tpu.reader as reader

    real_open = builtins.open

    def fake_open(path, *a, **k):
        if str(path) == "/proc/meminfo":
            raise OSError("no procfs")
        return real_open(path, *a, **k)

    (tmp_path / "a.dcm").write_bytes(b"x" * 2048)
    files = mia.file_parser(folder_path=str(tmp_path))
    with_proc = mia.check_memory(files)
    monkeypatch.setattr(builtins, "open", fake_open)
    expect = (os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")
              - 2048) / 1e9
    assert reader._available_memory_bytes() > 0
    assert abs(mia.check_memory(files) - expect) < 1.0
    assert with_proc > 0


def _require_8():
    if len(jax.devices()) < 8:
        pytest.skip("needs the conftest 8-device CPU mesh")


def test_preprocess_batch_mesh_shards_and_matches(rng):
    """preprocess_batch over 'data' places each series on its own
    device (no whole-cohort staging on one device) and matches the
    one-device result."""
    _require_8()
    from medicalimageanalysis_tpu.parallel.batch import preprocess_batch
    from medicalimageanalysis_tpu.parallel.mesh import make_mesh
    raw = rng.integers(-1000, 1500, size=(8, 4, 16, 16)).astype(np.int16)
    sl = np.ones(8, np.float32)
    ic = np.zeros(8, np.float32)
    mesh = make_mesh(8, space=1)
    v8, m8 = preprocess_batch(raw, sl, ic, out_shape=(4, 8, 8),
                              ffs_op="ax_rot1", mesh=mesh)
    assert len(v8.sharding.device_set) == 8
    assert v8.addressable_shards[0].data.shape == (1, 4, 8, 8)
    v1, m1 = preprocess_batch(raw, sl, ic, out_shape=(4, 8, 8),
                              ffs_op="ax_rot1")
    np.testing.assert_allclose(np.asarray(v8), np.asarray(v1), atol=1e-3)
    np.testing.assert_array_equal(np.asarray(m8), np.asarray(m1))


def test_gaussian_z_sharded_body_passes_default_checks(rng):
    """The halo Gaussian runs under jax.shard_map's default varying-axes
    validation and places the volume shard by shard."""
    _require_8()
    from scipy import ndimage

    from medicalimageanalysis_tpu.parallel.halo import gaussian_z_sharded
    from medicalimageanalysis_tpu.parallel.mesh import make_mesh
    mesh = make_mesh(8, space=8)
    vol = rng.normal(size=(32, 8, 8)).astype(np.float32)
    out = gaussian_z_sharded(vol, 1.0, mesh)
    assert len(out.sharding.device_set) == 8
    golden = ndimage.gaussian_filter1d(vol, sigma=1.0, axis=0,
                                       mode="nearest", truncate=4.0)
    np.testing.assert_allclose(np.asarray(out), golden, atol=2e-3)


def test_register_batch_mesh_matches_single(rng):
    """register_rigid_intensity_batch: the 'data'-sharded shard_map body
    (default checks) gives the one-device poses."""
    _require_8()
    from medicalimageanalysis_tpu.models.rigid_intensity import (
        register_rigid_intensity_batch)
    from medicalimageanalysis_tpu.parallel.mesh import make_mesh
    zz, yy, xx = np.mgrid[0:8, 0:16, 0:16].astype(np.float32)
    blob = np.exp(-(((zz - 4) / 2.5) ** 2 + ((yy - 8) / 4) ** 2
                    + ((xx - 7) / 4) ** 2)).astype(np.float32)
    refs = np.stack([blob] * 8)
    movs = np.roll(refs, 1, axis=3)
    eye = np.broadcast_to(np.eye(4, dtype=np.float32), (8, 4, 4)).copy()
    centers = np.tile(np.float32([8, 8, 4]), (8, 1))
    levels = ((1, 10, 0.1),)
    p8, _ = register_rigid_intensity_batch(refs, movs, eye, eye, centers,
                                           levels=levels,
                                           mesh=make_mesh(8, space=1))
    p1, _ = register_rigid_intensity_batch(refs, movs, eye, eye, centers,
                                           levels=levels)
    np.testing.assert_allclose(p8, p1, atol=1e-4)
