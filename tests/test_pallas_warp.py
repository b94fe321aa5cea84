"""Golden tests for the trilinear warp family (ops/warp.py) against an
independent numpy twin."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from medicalimageanalysis_tpu.ops.resample import (_trilinear,
                                                   affine_resample)
from medicalimageanalysis_tpu.ops.warp import (
    affine_coords, affine_warp, base_grid, coord_grads, field_warp,
    make_disp_sampler, make_warp_sampler, warp_disp)


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def _numpy_trilinear(vol, cz, cy, cx, bg):
    """Independent numpy golden (mirrors reference vtk/sitk linear
    interpolation semantics with clamped edge taps)."""
    Z, Y, X = vol.shape
    inside = ((cz >= 0) & (cz <= Z - 1) & (cy >= 0) & (cy <= Y - 1)
              & (cx >= 0) & (cx <= X - 1))
    z0 = np.clip(np.floor(cz).astype(int), 0, Z - 1)
    y0 = np.clip(np.floor(cy).astype(int), 0, Y - 1)
    x0 = np.clip(np.floor(cx).astype(int), 0, X - 1)
    z1 = np.minimum(z0 + 1, Z - 1)
    y1 = np.minimum(y0 + 1, Y - 1)
    x1 = np.minimum(x0 + 1, X - 1)
    fz, fy, fx = cz - np.floor(cz), cy - np.floor(cy), cx - np.floor(cx)
    out = 0.0
    for (zi, wz) in ((z0, 1 - fz), (z1, fz)):
        for (yi, wy) in ((y0, 1 - fy), (y1, fy)):
            for (xi, wx) in ((x0, 1 - fx), (x1, fx)):
                out = out + wz * wy * wx * vol[zi, yi, xi]
    return np.where(inside, out, bg).astype(np.float32)


def _rotation_matrix(deg, axis, shape_zyx):
    """Pixel matrix of a rotation about the volume centre."""
    from scipy.spatial.transform import Rotation
    ax = np.asarray(axis, float)
    R = Rotation.from_rotvec(np.deg2rad(deg) * ax
                             / np.linalg.norm(ax)).as_matrix()
    Z, Y, X = shape_zyx
    c = np.array([X / 2, Y / 2, Z / 2])
    A = np.eye(4)
    A[:3, :3] = R
    A[:3, 3] = c - R @ c
    return A


def _autodiff_warp(vol, cz, cy, cx):
    """Plain autodiff reference: the gather differentiated by JAX."""
    return _trilinear(jnp.asarray(vol), jnp.stack([cx, cy, cz], axis=-1),
                      jnp.float32(0.0))


def test_field_warp_smooth_dvf_matches_numpy(rng):
    vol = rng.normal(size=(20, 30, 70)).astype(np.float32)
    zz, yy, xx = np.mgrid[0:20, 0:30, 0:70].astype(np.float32)
    cz = zz + 3.0 * np.sin(xx / 15) * np.cos(yy / 9)
    cy = yy - 2.5 * np.cos(zz / 5)
    cx = xx + 4.0 * np.sin(yy / 7)
    out = field_warp(vol, cz, cy, cx, background=-3001.0)
    golden = _numpy_trilinear(vol, cz, cy, cx, -3001.0)
    np.testing.assert_allclose(np.asarray(out), golden, atol=2e-4)


def test_field_warp_large_displacement_small_variation(rng):
    """A large constant displacement samples the shifted volume and
    backgrounds what falls outside it."""
    vol = rng.normal(size=(64, 24, 130)).astype(np.float32)
    zz, yy, xx = np.mgrid[0:64, 0:24, 0:130].astype(np.float32)
    cz = zz - 37.25          # constant 37-voxel shift
    cy = yy + 11.5
    cx = xx - 55.75
    out = field_warp(vol, cz, cy, cx)
    golden = _numpy_trilinear(vol, cz, cy, cx, 0.0)
    np.testing.assert_allclose(np.asarray(out), golden, atol=2e-4)


def test_field_warp_overflow_fallback_is_exact(rng):
    """A field with per-column jumps of 21 voxels is sampled exactly."""
    vol = rng.normal(size=(24, 24, 70)).astype(np.float32)
    zz, yy, xx = np.mgrid[0:24, 0:24, 0:70].astype(np.float32)
    cz = zz + np.where((xx.astype(int) % 9) == 0, 18.0, -3.0)
    out = np.asarray(field_warp(vol, cz, yy, xx))
    golden = _numpy_trilinear(vol, cz, yy, xx, 0.0)
    np.testing.assert_allclose(out, golden, atol=2e-4)


def test_affine_warp_matches_affine_resample(rng):
    from scipy.spatial.transform import Rotation
    vol = rng.normal(size=(20, 30, 70)).astype(np.float32)
    A = np.eye(4)
    A[:3, :3] = Rotation.from_euler("zyx", [8, -5, 3],
                                    degrees=True).as_matrix()
    A[:3, 3] = [3.5, -2.0, 1.25]
    out = np.asarray(affine_warp(vol, A, (24, 32, 80), background=-3001.0))
    ref = np.asarray(affine_resample(vol, A, (24, 32, 80),
                                     background=-3001.0))
    np.testing.assert_allclose(out, ref, atol=2e-4)


def test_batched_volumes_share_coords(rng):
    vol = rng.normal(size=(3, 16, 20, 40)).astype(np.float32)
    zz, yy, xx = np.mgrid[0:16, 0:20, 0:40].astype(np.float32)
    cz, cy, cx = zz + 0.5, yy - 0.25, xx + 1.5
    out = np.asarray(field_warp(vol, cz, cy, cx))
    for b in range(3):
        golden = _numpy_trilinear(vol[b], cz, cy, cx, 0.0)
        np.testing.assert_allclose(out[b], golden, atol=2e-4)


def test_field_warp_batched_matches_loop(rng):
    """The vmapped (B, Z, Y, X) warp equals warping each volume on its
    own (to f32 rounding: fusion may reorder the lerp), for coordinates
    and displacement fields alike."""
    vols = rng.normal(size=(4, 9, 13, 17)).astype(np.float32)
    disp = rng.normal(scale=1.5, size=(3, 9, 13, 17)).astype(np.float32)
    zz, yy, xx = base_grid(vols.shape[1:])
    cz, cy, cx = zz + disp[2], yy + disp[1], xx + disp[0]
    batched = np.asarray(field_warp(vols, cz, cy, cx, -5.0))
    loop = np.stack([np.asarray(field_warp(v, cz, cy, cx, -5.0))
                     for v in vols])
    np.testing.assert_allclose(batched, loop, rtol=0, atol=1e-6)
    np.testing.assert_allclose(np.asarray(warp_disp(vols, disp, -5.0)),
                               loop, rtol=0, atol=1e-6)


def test_sampler_vjp_matches_xla_autodiff(rng):
    vol = rng.normal(size=(16, 18, 40)).astype(np.float32)
    zz, yy, xx = np.mgrid[0:16, 0:18, 0:40].astype(np.float32)
    cz = jnp.asarray(zz + 1.5 * np.sin(xx / 9))
    cy = jnp.asarray(yy - 1.0 * np.cos(zz / 4))
    cx = jnp.asarray(xx + 2.0 * np.sin(yy / 6))
    sampler = make_warp_sampler(vol, background=0.0)

    g1 = jax.grad(lambda a, b, c: jnp.sum(sampler(a, b, c) ** 2),
                  argnums=(0, 1, 2))(cz, cy, cx)
    g2 = jax.grad(lambda a, b, c: jnp.sum(_autodiff_warp(vol, a, b, c) ** 2),
                  argnums=(0, 1, 2))(cz, cy, cx)
    for a, b in zip(g1, g2):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b),
                                   atol=1e-3)


def test_coord_grads_match_finite_differences(rng):
    """coord_grads is the exact trilinear derivative: central
    differences of the numpy golden agree away from cell faces, and
    samples outside the volume get a zero gradient."""
    vol = rng.normal(size=(8, 9, 10)).astype(np.float32)
    n = 200
    cz = rng.uniform(0.1, 6.9, n).astype(np.float32)
    cy = rng.uniform(0.1, 7.9, n).astype(np.float32)
    cx = rng.uniform(0.1, 8.9, n).astype(np.float32)
    # keep every sample >= 0.05 voxel from a cell face
    for c in (cz, cy, cx):
        f = c - np.floor(c)
        c += np.where(f < 0.05, 0.05, 0.0) - np.where(f > 0.95, 0.05, 0.0)
    gz, gy, gx = (np.asarray(g) for g in coord_grads(vol, cz, cy, cx))
    h = 1e-2
    vol64 = vol.astype(np.float64)
    for g, axis in ((gz, 0), (gy, 1), (gx, 2)):
        lo = [cz.astype(np.float64), cy.astype(np.float64),
              cx.astype(np.float64)]
        hi = [c.copy() for c in lo]
        lo[axis] = lo[axis] - h
        hi[axis] = hi[axis] + h
        fd = (_numpy_trilinear(vol64, *hi, 0.0).astype(np.float64)
              - _numpy_trilinear(vol64, *lo, 0.0)) / (2 * h)
        np.testing.assert_allclose(g, fd, atol=2e-3)
    out = coord_grads(vol, np.float32([-1.0]), np.float32([2.0]),
                      np.float32([3.0]))
    assert all(float(g[0]) == 0.0 for g in out)


def test_affine_coords_convention(rng):
    """affine_coords must agree with affine_resample's coordinate map
    (output pixel (x,y,z,1) -> input pixel, x-major matrix rows)."""
    A = np.array([[1.1, 0.02, -0.01, 3.0],
                  [0.03, 0.9, 0.04, -2.0],
                  [-0.02, 0.01, 1.05, 1.0],
                  [0, 0, 0, 1.0]], np.float32)
    cz, cy, cx = affine_coords(A, (4, 5, 6))
    z, y, x = 2, 3, 4
    v = A @ np.array([x, y, z, 1.0], np.float32)
    assert np.allclose([float(cx[z, y, x]), float(cy[z, y, x]),
                        float(cz[z, y, x])], v[:3], atol=1e-5)


def test_register_level_pallas_parity_smoke(rng):
    """The two ways registration samples the moving volume agree: the
    grid warp over affine coordinates and the flat point sampler of
    _register_level at a test pose."""
    from medicalimageanalysis_tpu.models.rigid_intensity import (
        pose_to_matrix)
    from medicalimageanalysis_tpu.ops.resample import (
        make_trilinear_sampler)

    ref = rng.normal(size=(16, 20, 24)).astype(np.float32)
    mov = np.roll(ref, 2, axis=2)
    pose = jnp.asarray([0.01, -0.02, 0.015, 1.0, -0.5, 0.25],
                       jnp.float32)
    center = jnp.asarray([12.0, 10.0, 8.0])
    P = pose_to_matrix(pose, center)
    cz, cy, cx = affine_coords(P, ref.shape)
    vals_grid = field_warp(mov, cz, cy, cx)
    pts = jnp.stack([cx.ravel(), cy.ravel(), cz.ravel()], axis=-1)
    vals_flat = make_trilinear_sampler(mov, 0.0)(pts)
    np.testing.assert_allclose(np.asarray(vals_grid).ravel(),
                               np.asarray(vals_flat), atol=2e-4)


def test_affine_warp_fused_matches_eager(rng):
    """Small and near-90-degree rotations through affine_resample match
    the numpy golden (the gather needs no input relayout)."""
    from scipy.spatial.transform import Rotation

    vol = rng.normal(size=(18, 24, 40)).astype(np.float32)
    for angles, shift in (([5, -4, 3], [2.0, -1.5, 0.75]),
                          ([91, 2, -3], [3.0, 30.5, 1.0])):
        A = np.eye(4)
        A[:3, :3] = Rotation.from_euler("zyx", angles,
                                        degrees=True).as_matrix()
        A[:3, 3] = shift
        out = np.asarray(affine_resample(vol, A, (20, 26, 42),
                                         background=-3001.0))
        cz, cy, cx = (np.asarray(c) for c in affine_coords(A, (20, 26, 42)))
        golden = _numpy_trilinear(vol, cz, cy, cx, -3001.0)
        np.testing.assert_allclose(out, golden, atol=3e-4)


def test_disp_mode_matches_xla_twin(rng):
    """warp_disp (planar (3, Zo, Yo, Xo) field on an output grid of its
    own shape) matches the numpy golden, for one volume and a batch."""
    vol = rng.normal(size=(21, 29, 71)).astype(np.float32)
    disp = rng.normal(scale=2.0, size=(3, 18, 27, 66)).astype(np.float32)
    Zo, Yo, Xo = disp.shape[1:]
    zz = np.arange(Zo, dtype=np.float32)[:, None, None]
    yy = np.arange(Yo, dtype=np.float32)[None, :, None]
    xx = np.arange(Xo, dtype=np.float32)[None, None, :]
    cz, cy, cx = (np.broadcast_to(c, (Zo, Yo, Xo)) for c in
                  (zz + disp[2], yy + disp[1], xx + disp[0]))
    out = warp_disp(jnp.asarray(vol), jnp.asarray(disp), 0.25)
    np.testing.assert_allclose(np.asarray(out),
                               _numpy_trilinear(vol, cz, cy, cx, 0.25),
                               atol=1e-5)

    volb = rng.normal(size=(3, 21, 29, 71)).astype(np.float32)
    outb = np.asarray(warp_disp(jnp.asarray(volb), jnp.asarray(disp), 0.0))
    for b in range(3):
        np.testing.assert_allclose(
            outb[b], _numpy_trilinear(volb[b], cz, cy, cx, 0.0), atol=1e-5)


def test_affine_mode_in_kernel_coords(rng):
    """A general (sheared, scaled) affine through affine_warp matches
    the numpy golden on a differently shaped output grid."""
    vol = rng.normal(size=(19, 33, 67)).astype(np.float32)
    A = np.eye(4, dtype=np.float32)
    A[:3, :3] += rng.normal(scale=0.05, size=(3, 3)).astype(np.float32)
    A[:3, 3] = [2.5, -1.0, 0.5]
    osh = (17, 30, 70)
    cz, cy, cx = (np.asarray(c) for c in affine_coords(A, osh))
    out = affine_warp(jnp.asarray(vol), jnp.asarray(A), osh, -3001.0)
    np.testing.assert_allclose(np.asarray(out),
                               _numpy_trilinear(vol, cz, cy, cx, -3001.0),
                               atol=5e-4)


def test_invert_dvf_rough_field_roundtrip(rng):
    """invert_dvf on a rough field: compose(d, v) ~ 0 in the interior."""
    from scipy.ndimage import gaussian_filter
    from medicalimageanalysis_tpu.ops.registration.dvf import (
        compose_dvf, invert_dvf)

    d = rng.normal(scale=4.0, size=(24, 28, 32, 3)).astype(np.float32)
    for c in range(3):
        d[..., c] = gaussian_filter(d[..., c], sigma=3.0) * 6.0
    sp = (1.0, 1.0, 1.0)
    v = invert_dvf(d, sp, iterations=30)
    resid = compose_dvf(d, v, sp)
    interior = resid[6:-6, 6:-6, 6:-6]
    assert np.abs(interior).max() < 0.35


def test_disp_sampler_vjp_matches_xla_autodiff(rng):
    """make_disp_sampler's VJP (cotangent = g * coordinate gradients,
    planar) must match XLA autodiff through the gather."""
    vol = rng.normal(size=(12, 16, 40)).astype(np.float32)
    disp = (0.8 * rng.normal(size=(3, 12, 16, 40))).astype(np.float32)
    sampler = make_disp_sampler(vol, background=0.0)
    g1 = jax.grad(lambda d: jnp.sum(sampler(d) ** 2))(jnp.asarray(disp))

    zz, yy, xx = base_grid(vol.shape)

    def xla_loss(d):
        out = _autodiff_warp(vol, zz + d[2], yy + d[1], xx + d[0])
        return jnp.sum(out ** 2)

    g2 = jax.grad(xla_loss)(jnp.asarray(disp))
    np.testing.assert_allclose(np.asarray(g1), np.asarray(g2), atol=1e-3)


def test_oblique_shear_kernel_exact(rng):
    """Fully oblique (30-60 degree) rotations resample exactly: the
    affine path matches the independent numpy golden."""
    Z, Y, X = 20, 28, 36
    vol = rng.normal(size=(Z, Y, X)).astype(np.float32)
    for deg, axis in [(45.0, (0, 0, 1)), (60.0, (0, 0, 1)),
                      (45.0, (1, 1, 1)), (33.0, (1, 2, 0.5))]:
        A = _rotation_matrix(deg, axis, (Z, Y, X))
        out = affine_resample(vol, A, (Z, Y, X), background=-3001.0)
        cz, cy, cx = affine_coords(A, (Z, Y, X))
        golden = _numpy_trilinear(vol, np.asarray(cz), np.asarray(cy),
                                  np.asarray(cx), -3001.0)
        np.testing.assert_allclose(np.asarray(out), golden, atol=2e-4)
