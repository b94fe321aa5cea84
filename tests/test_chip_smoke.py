"""CPU tests of chip_smoke.py: its numpy references at tiny size, the
tiny end-to-end rehearsal, and its refusal to run without a GPU."""

import importlib.util
import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "chip_smoke.py")


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", SCRIPT)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(args, cwd, extra_env=None):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.update(extra_env or {})
    return subprocess.run([sys.executable] + args, cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_chip_smoke_exits_nonzero_without_gpu():
    r = _run([SCRIPT], ROOT)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


def test_chip_smoke_fails_alone_in_a_directory(tmp_path):
    """Without the package beside it the script cannot run, even in the
    rehearsal mode that accepts the CPU."""
    shutil.copy(SCRIPT, tmp_path / "chip_smoke.py")
    r = _run(["chip_smoke.py", "--tiny"], str(tmp_path),
             {"PYTHONPATH": ""})
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_chip_smoke_tiny_rehearsal(smoke, capsys):
    assert smoke.main(["--tiny"]) == 0
    out = capsys.readouterr().out
    for phase in ("ingest", "preprocess", "structures", "rigid",
                  "deformable"):
        assert f"phase={phase} " in out
    assert "tiny rehearsal passed" in out
    assert '"ok"' not in out


def test_ref_preprocess_matches_library(smoke, rng):
    from medicalimageanalysis_tpu.parallel.batch import make_preprocess_fn
    raw = rng.integers(-1024, 2000, size=(2, 6, 20, 28)).astype(np.int16)
    slope = np.float32([1.0, 0.5])
    icept = np.float32([0.0, -20.0])
    fn = jax.jit(make_preprocess_fn((6, 20, 28), (5, 14, 9),
                                    ffs_op="ax_rot2", threshold=-250.0,
                                    sigma_vox=1.0))
    vols, masks = fn(raw, slope, icept)
    for b in range(2):
        ref_v, ref_b = smoke.ref_preprocess(raw[b], float(slope[b]),
                                            float(icept[b]), (5, 14, 9),
                                            2, 1.0)
        np.testing.assert_allclose(np.asarray(vols[b]), ref_v, atol=1e-2)
        near = np.abs(ref_b - (-250.0)) <= 1e-2
        assert np.all((np.asarray(masks[b]) > 0) == (ref_b > -250.0)
                      | near)


def test_ref_rasterize_matches_device_rasterizer(smoke, rng):
    """The numpy scanline twin agrees bit for bit with the device
    rasterizer on convex, concave, overlapping (XOR) and out-of-canvas
    polygons."""
    from medicalimageanalysis_tpu.ops.rasterize import rasterize_polygons
    S, H, W = 4, 40, 52
    contours = []
    th = np.linspace(0, 2 * np.pi, 17, endpoint=False)
    for k in range(9):
        r = (4 + 3 * rng.random()) * (1 + 0.4 * np.cos(5 * th) * (k % 2))
        cx, cy = 5 + 45 * rng.random(), 5 + 32 * rng.random()
        xy = np.stack([cx + r * np.cos(th), cy + 0.8 * r * np.sin(th)], 1)
        c = np.concatenate([xy, np.full((len(th), 1), float(k % S))], 1)
        contours.append(np.vstack([c, c[:1]]))
    ref = smoke.ref_rasterize(contours, (S, H, W))
    polys = [c[:, :2] for c in contours]
    slices = [int(np.round(c[0, 2])) for c in contours]
    got = rasterize_polygons(polys, slices, S, H, W)
    assert ref.sum() > 0
    np.testing.assert_array_equal(np.asarray(got), ref)


def test_ref_trilinear_matches_library_warp(smoke, rng):
    from medicalimageanalysis_tpu.ops.warp import field_warp
    vol = rng.normal(size=(7, 9, 11)).astype(np.float32)
    cz = rng.uniform(-1, 7, (5, 6, 4)).astype(np.float32)
    cy = rng.uniform(-1, 9, (5, 6, 4)).astype(np.float32)
    cx = rng.uniform(-1, 11, (5, 6, 4)).astype(np.float32)
    ref = smoke.ref_trilinear(vol, np.stack([cz, cy, cx]), -7.0)
    got = np.asarray(field_warp(vol, cz, cy, cx, -7.0))
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_ref_below_counts_matches_count_below(smoke, rng):
    from medicalimageanalysis_tpu.ops.dvh import count_below
    vals = rng.uniform(0, 70, 5000).astype(np.float32)
    bins = np.linspace(0.0, 75.0, 300)
    np.testing.assert_array_equal(smoke.ref_below_counts(vals, bins),
                                  np.asarray(count_below(vals, bins)))


def test_rigid_transform_round_trip(smoke):
    """warp_by_physical(vol, M) then M^-1 restores the interior."""
    from scipy.ndimage import gaussian_filter
    vol = gaussian_filter(np.random.default_rng(3).normal(
        size=(10, 24, 24)), 2.0) * 100
    origin, sp = np.array([-12.0, -12.0, -10.0]), (1.0, 1.0, 2.0)
    T = smoke.rigid_transform(3.0, [0.5, -0.5, 0.5], np.zeros(3))
    there = smoke.warp_by_physical(vol, origin, sp, np.linalg.inv(T), 0.0)
    back = smoke.warp_by_physical(there, origin, sp, T, 0.0)
    inner = (slice(3, -3), slice(6, -6), slice(6, -6))
    assert np.abs(back[inner] - vol[inner]).max() < 0.1 * np.abs(vol).max()


def _jaxpr_precisions(fn, *args):
    """Precision of every dot_general in fn's jaxpr (nested included)."""
    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name == "dot_general":
                found.append(eqn.params["precision"])
            for v in eqn.params.values():
                for sub in (v if isinstance(v, (list, tuple)) else [v]):
                    if hasattr(sub, "jaxpr"):
                        walk(sub.jaxpr if hasattr(sub.jaxpr, "eqns")
                             else sub.jaxpr.jaxpr)
                    elif hasattr(sub, "eqns"):
                        walk(sub)
    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return found


def _all_highest(precs):
    hi = jax.lax.Precision.HIGHEST
    return bool(precs) and all(
        p is not None and all(q == hi for q in
                              (p if isinstance(p, tuple) else (p,)))
        for p in precs)


@pytest.mark.parametrize("name", ["preprocess", "separable_resample",
                                  "gaussian_filter", "demons_smoothing",
                                  "rigid_geometry"])
def test_precision_pins(name):
    """Every float32 contraction on the checked main path asks for
    Precision.HIGHEST explicitly (no global flag): under the GPU's
    default TF32 they break the preprocess and rigid tolerances."""
    from medicalimageanalysis_tpu.ops.filters import _separable3
    from medicalimageanalysis_tpu.ops.registration.demons import (
        _smooth_field)
    from medicalimageanalysis_tpu.ops.resample import _separable_apply
    from medicalimageanalysis_tpu.parallel.batch import make_preprocess_fn
    from medicalimageanalysis_tpu.models.rigid_intensity import (
        pose_to_matrix)

    m = jnp.eye(4, dtype=jnp.float32)
    v = jnp.ones((4, 4, 4), jnp.float32)
    cases = {
        "preprocess": (make_preprocess_fn((4, 4, 4), (4, 4, 4)),
                       (jnp.ones((1, 4, 4, 4), jnp.int16),
                        jnp.ones(1), jnp.zeros(1))),
        "separable_resample": (_separable_apply, (v, m, m, m)),
        "gaussian_filter": (_separable3, (v, m, m, m)),
        "demons_smoothing": (_smooth_field,
                             (jnp.ones((3, 4, 4, 4)), m, m, m)),
        "rigid_geometry": (pose_to_matrix,
                           (jnp.full(6, 0.1), jnp.ones(3))),
    }
    fn, args = cases[name]
    assert _all_highest(_jaxpr_precisions(fn, *args)), name
