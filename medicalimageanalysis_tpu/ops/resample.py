"""Affine / separable volume resampling kernels.

Device replacement for VTK ``vtkImageReslice`` (reference
structure/image.py:160-215, rigid.py:691-740) and SimpleITK
``ResampleImageFilter`` (reference structure/dose.py:760-764,
utils/deformable/simpleitk.py:76-94):

- :func:`trilinear_gather` — fused 8-neighbor gather+lerp with background
  fill, the workhorse primitive (jit once per shape).
- :func:`affine_resample` — one 4x4 matrix maps output voxel -> input
  voxel; covers oblique reslice, rigid overlay, grid-to-grid resample.
- :func:`separable_resample` — axis-aligned rescale expressed as three
  interpolation-matrix contractions, so XLA runs matrix products
  instead of the gather path (isotropic resample of batched volumes).
- :func:`reslice_rotation` — vtkImageReslice(AutoCrop, linear,
  background -3001) behavioral equivalent used by the Display classes.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from ..config import config
from . import geometry as geo

__all__ = ["trilinear_gather", "affine_resample", "separable_resample",
           "reslice_rotation", "map_coordinates_trilinear"]


@partial(jax.jit, static_argnames=())
def _trilinear(vol, coords_xyz, background):
    """vol: (Z, Y, X); coords_xyz: (..., 3) in pixel (x, y, z) order."""
    Z, Y, X = vol.shape
    x = coords_xyz[..., 0]
    y = coords_xyz[..., 1]
    z = coords_xyz[..., 2]

    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    z0 = jnp.floor(z)
    fx = x - x0
    fy = y - y0
    fz = z - z0

    inside = ((x >= 0) & (x <= X - 1) & (y >= 0) & (y <= Y - 1)
              & (z >= 0) & (z <= Z - 1))

    x0i = jnp.clip(x0.astype(jnp.int32), 0, X - 1)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, Y - 1)
    z0i = jnp.clip(z0.astype(jnp.int32), 0, Z - 1)
    x1i = jnp.clip(x0i + 1, 0, X - 1)
    y1i = jnp.clip(y0i + 1, 0, Y - 1)
    z1i = jnp.clip(z0i + 1, 0, Z - 1)

    flat = vol.reshape(-1)

    def take(zi, yi, xi):
        return jnp.take(flat, (zi * Y + yi) * X + xi)

    c000 = take(z0i, y0i, x0i)
    c001 = take(z0i, y0i, x1i)
    c010 = take(z0i, y1i, x0i)
    c011 = take(z0i, y1i, x1i)
    c100 = take(z1i, y0i, x0i)
    c101 = take(z1i, y0i, x1i)
    c110 = take(z1i, y1i, x0i)
    c111 = take(z1i, y1i, x1i)

    c00 = c000 * (1 - fx) + c001 * fx
    c01 = c010 * (1 - fx) + c011 * fx
    c10 = c100 * (1 - fx) + c101 * fx
    c11 = c110 * (1 - fx) + c111 * fx
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    out = c0 * (1 - fz) + c1 * fz

    return jnp.where(inside, out, background)


def _trilinear_parts(vol, coords_xyz, background):
    """Forward trilinear + the residuals the analytic coord-grad needs."""
    Z, Y, X = vol.shape
    x = coords_xyz[..., 0]
    y = coords_xyz[..., 1]
    z = coords_xyz[..., 2]
    x0 = jnp.floor(x)
    y0 = jnp.floor(y)
    z0 = jnp.floor(z)
    fx = x - x0
    fy = y - y0
    fz = z - z0
    inside = ((x >= 0) & (x <= X - 1) & (y >= 0) & (y <= Y - 1)
              & (z >= 0) & (z <= Z - 1))
    x0i = jnp.clip(x0.astype(jnp.int32), 0, X - 1)
    y0i = jnp.clip(y0.astype(jnp.int32), 0, Y - 1)
    z0i = jnp.clip(z0.astype(jnp.int32), 0, Z - 1)
    x1i = jnp.clip(x0i + 1, 0, X - 1)
    y1i = jnp.clip(y0i + 1, 0, Y - 1)
    z1i = jnp.clip(z0i + 1, 0, Z - 1)
    flat = vol.reshape(-1)

    def take(zi, yi, xi):
        return jnp.take(flat, (zi * Y + yi) * X + xi)

    c = (take(z0i, y0i, x0i), take(z0i, y0i, x1i),
         take(z0i, y1i, x0i), take(z0i, y1i, x1i),
         take(z1i, y0i, x0i), take(z1i, y0i, x1i),
         take(z1i, y1i, x0i), take(z1i, y1i, x1i))
    c00 = c[0] * (1 - fx) + c[1] * fx
    c01 = c[2] * (1 - fx) + c[3] * fx
    c10 = c[4] * (1 - fx) + c[5] * fx
    c11 = c[6] * (1 - fx) + c[7] * fx
    c0 = c00 * (1 - fy) + c01 * fy
    c1 = c10 * (1 - fy) + c11 * fy
    out = jnp.where(inside, c0 * (1 - fz) + c1 * fz, background)
    return out, (c, fx, fy, fz, c00, c01, c10, c11, c0, c1, inside)


def make_trilinear_sampler(vol, background=0.0):
    """Differentiable sampler with an analytic coordinate VJP.

    Autodiff through the gather re-reads the 8 corners in the backward
    pass (and scan rematerialization repeats the gathers); this closes
    over the volume and computes d(out)/d(coords) from saved corner
    values only — the hot path for intensity registration."""
    vol = jnp.asarray(vol, dtype=jnp.float32)
    background = jnp.float32(background)

    @jax.custom_vjp
    def sample(coords):
        return _trilinear_parts(vol, coords, background)[0]

    def fwd(coords):
        out, res = _trilinear_parts(vol, coords, background)
        return out, res

    def bwd(res, g):
        c, fx, fy, fz, c00, c01, c10, c11, c0, c1, inside = res
        gm = jnp.where(inside, g, 0.0)
        dx = ((c[1] - c[0]) * (1 - fy) + (c[3] - c[2]) * fy) * (1 - fz) \
            + ((c[5] - c[4]) * (1 - fy) + (c[7] - c[6]) * fy) * fz
        dy = (c01 - c00) * (1 - fz) + (c11 - c10) * fz
        dz = c1 - c0
        grad = jnp.stack([gm * dx, gm * dy, gm * dz], axis=-1)
        return (grad,)

    sample.defvjp(fwd, bwd)
    return sample


def trilinear_gather(volume, coords_xyz, background=None):
    """Trilinear sample of `volume` at fractional pixel coords (x, y, z).

    Out-of-bounds samples return `background` (default config fill -3001,
    matching reference structure/image.py:195).
    """
    if background is None:
        background = config.background_fill
    vol = jnp.asarray(volume, dtype=jnp.float32)
    coords = jnp.asarray(coords_xyz, dtype=jnp.float32)
    return _trilinear(vol, coords, jnp.float32(background))


def map_coordinates_trilinear(volume, coords_zyx, background=0.0):
    """scipy.ndimage.map_coordinates(order=1) equivalent; coords (3, ...)
    in (z, y, x) order (used by DVF mesh warping, reference
    structure/deformable.py:961-1001)."""
    coords = jnp.stack([coords_zyx[2], coords_zyx[1], coords_zyx[0]],
                       axis=-1)
    return trilinear_gather(volume, coords, background)


@partial(jax.jit, static_argnames=("out_shape",))
def _affine_resample_jit(vol, A, out_shape, background):
    oz, oy, ox = out_shape
    zz = jnp.arange(oz, dtype=jnp.float32)
    yy = jnp.arange(oy, dtype=jnp.float32)
    xx = jnp.arange(ox, dtype=jnp.float32)
    Zg, Yg, Xg = jnp.meshgrid(zz, yy, xx, indexing="ij")
    # output pixel coords in (x, y, z, 1) homogeneous order
    src_x = A[0, 0] * Xg + A[0, 1] * Yg + A[0, 2] * Zg + A[0, 3]
    src_y = A[1, 0] * Xg + A[1, 1] * Yg + A[1, 2] * Zg + A[1, 3]
    src_z = A[2, 0] * Xg + A[2, 1] * Yg + A[2, 2] * Zg + A[2, 3]
    coords = jnp.stack([src_x, src_y, src_z], axis=-1)
    return _trilinear(vol, coords, background)


def affine_resample(volume, pixel_matrix, out_shape, background=None):
    """Resample through a single 4x4 *pixel-to-pixel* matrix.

    `pixel_matrix` maps output pixel (x, y, z, 1) -> input pixel
    (x, y, z). Compose it from grid geometries with
    :func:`compose_pixel_matrix`.
    """
    if background is None:
        background = config.background_fill
    vol = jnp.asarray(volume, dtype=jnp.float32)
    A = jnp.asarray(pixel_matrix, dtype=jnp.float32)
    return _affine_resample_jit(vol, A, tuple(int(s) for s in out_shape),
                                jnp.float32(background))


def compose_pixel_matrix(in_matrix, in_spacing, in_origin,
                         out_matrix, out_spacing, out_origin,
                         phys_transform=None):
    """Build the output-pixel -> input-pixel 4x4.

    A = P2Pix_in @ T_phys @ Pix2P_out, where T_phys maps output physical
    points into input physical space (identity when both grids live in
    the same frame of reference).
    """
    pix2p_out = geo.pixel_to_position_matrix(out_matrix, out_spacing,
                                             out_origin).astype(np.float64)
    p2pix_in = geo.position_to_pixel_matrix(in_matrix, in_spacing,
                                            in_origin).astype(np.float64)
    if phys_transform is None:
        return (p2pix_in @ pix2p_out).astype(np.float32)
    return (p2pix_in @ np.asarray(phys_transform, dtype=np.float64)
            @ pix2p_out).astype(np.float32)


def _interp_matrix(n_out, n_in, scale, offset=0.0, dtype=np.float32):
    """(n_out, n_in) row-stochastic linear interpolation matrix.

    Row i has weight (1-f) at floor(i*scale+offset) and f at +1 —
    a dense matmul replaces the gather for axis-aligned
    resampling.
    """
    src = np.arange(n_out, dtype=np.float64) * scale + offset
    src = np.clip(src, 0, n_in - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    f = (src - lo).astype(np.float64)
    m = np.zeros((n_out, n_in), dtype=np.float64)
    m[np.arange(n_out), lo] += 1 - f
    m[np.arange(n_out), hi] += f
    return m.astype(dtype)


# float32 contractions: the GPU's default TF32 keeps ~3 decimal digits,
# which moves a resampled HU value by whole units
_HIGHEST = jax.lax.Precision.HIGHEST


@jax.jit
def _separable_apply(vol, mz, my, mx):
    out = jnp.einsum("ij,jyx->iyx", mz, vol, precision=_HIGHEST,
                     preferred_element_type=jnp.float32)
    out = jnp.einsum("kj,zjx->zkx", my, out, precision=_HIGHEST,
                     preferred_element_type=jnp.float32)
    out = jnp.einsum("lj,zyj->zyl", mx, out, precision=_HIGHEST,
                     preferred_element_type=jnp.float32)
    return out


def separable_resample(volume, out_shape, in_spacing_zyx=None,
                       out_spacing_zyx=None):
    """Axis-aligned trilinear resample as three matrix contractions.

    If spacings are given, sampling positions follow physical spacing
    ratios (origin-aligned); otherwise shape ratios.
    """
    vol = jnp.asarray(volume, dtype=jnp.float32)
    iz, iy, ix = vol.shape
    oz, oy, ox = (int(s) for s in out_shape)
    if in_spacing_zyx is not None and out_spacing_zyx is not None:
        sz = out_spacing_zyx[0] / in_spacing_zyx[0]
        sy = out_spacing_zyx[1] / in_spacing_zyx[1]
        sx = out_spacing_zyx[2] / in_spacing_zyx[2]
    else:
        sz = iz / oz
        sy = iy / oy
        sx = ix / ox
    mz = jnp.asarray(_interp_matrix(oz, iz, sz))
    my = jnp.asarray(_interp_matrix(oy, iy, sy))
    mx = jnp.asarray(_interp_matrix(ox, ix, sx))
    return _separable_apply(vol, mz, my, mx)


def reslice_transform(volume, vol_matrix, vol_spacing, vol_origin,
                      phys_transform, out_spacing, background=None):
    """vtkImageReslice(AutoCrop) behavioral equivalent with an arbitrary
    physical reslice transform (reference structure/rigid.py:691-740):
    output grid has identity direction and `out_spacing`; output point p
    samples the input volume at ``phys_transform @ p``; the output
    extent covers the inverse-transformed input bounding box.

    Returns dict(array (Z,Y,X) float32, origin, spacing, dimensions).
    """
    if background is None:
        background = config.background_fill
    volume = np.asarray(volume)
    T = np.asarray(phys_transform, dtype=np.float64)
    out_spacing = np.asarray(out_spacing, dtype=np.float64)

    Z, Y, X = volume.shape
    pix2p = geo.pixel_to_position_matrix(vol_matrix, vol_spacing,
                                         vol_origin)
    corners_pix = np.array([[x, y, z] for z in (0, Z - 1)
                            for y in (0, Y - 1) for x in (0, X - 1)],
                           dtype=np.float64)
    corners_phys = geo.apply_homogeneous(corners_pix, pix2p)
    out_corners = geo.apply_homogeneous(corners_phys, np.linalg.inv(T))
    lo = out_corners.min(axis=0)
    hi = out_corners.max(axis=0)
    out_dims = np.maximum(
        np.round((hi - lo) / out_spacing).astype(int) + 1, 1)

    A = compose_pixel_matrix(vol_matrix, vol_spacing, vol_origin,
                             np.eye(3), out_spacing, lo,
                             phys_transform=T)
    out_shape = (int(out_dims[2]), int(out_dims[1]), int(out_dims[0]))
    arr = np.asarray(affine_resample(volume, A, out_shape, background))
    return {"array": arr, "origin": lo, "spacing": out_spacing,
            "dimensions": np.asarray(out_dims)}


def reslice_rotation(volume, volume_matrix, spacing, origin, display_matrix,
                     background=None):
    """Behavioral equivalent of the reference's off-axis
    vtkImageReslice pipeline (reference structure/image.py:160-215):

    rotate the (direction-matrix'd) volume into an identity-direction
    output grid with the same spacing, auto-cropped to the rotated
    bounding box, linear interpolation, background fill.

    Returns (resliced_array (Z,Y,X) float32 numpy, new_origin (3,) in the
    *rotated* frame mapped back through the rotation — matching the
    reference's ``transform.TransformPoint(new_origin)``).
    """
    if background is None:
        background = config.background_fill
    volume = np.asarray(volume)
    spacing = np.asarray(spacing, dtype=np.float64)
    origin = np.asarray(origin, dtype=np.float64)
    vol_mat = np.asarray(volume_matrix, dtype=np.float64)
    R = np.asarray(display_matrix, dtype=np.float64)[:3, :3]

    # physical corners of the input volume (index space x,y,z extents)
    Z, Y, X = volume.shape
    pix2p = geo.pixel_to_position_matrix(vol_mat, spacing, origin)
    corners_pix = np.array([[x, y, z] for z in (0, Z - 1)
                            for y in (0, Y - 1) for x in (0, X - 1)],
                           dtype=np.float64)
    corners_phys = geo.apply_homogeneous(corners_pix, pix2p)

    # vtkImageReslice applies the *inverse* of the display rotation to
    # output points; equivalently output frame = R @ input physical.
    rotated = corners_phys @ R.T
    lo = rotated.min(axis=0)
    hi = rotated.max(axis=0)
    out_dims = np.maximum(np.round((hi - lo) / spacing).astype(int) + 1, 1)

    # output grid: identity direction, spacing, origin at bbox min (in the
    # rotated frame). Output point p_out maps to input physical R^-1 p_out.
    T_phys = np.eye(4)
    T_phys[:3, :3] = R.T  # R^-1 for pure rotation
    A = compose_pixel_matrix(vol_mat, spacing, origin,
                             np.eye(3), spacing, lo, phys_transform=T_phys)
    out_shape = (int(out_dims[2]), int(out_dims[1]), int(out_dims[0]))
    out = affine_resample(volume, A, out_shape, background)

    new_origin = R.T @ lo  # back through the rotation, as the reference does
    return np.asarray(out), new_origin
