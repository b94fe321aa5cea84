"""Exact trilinear warps of one volume or a batch of volumes.

The warp family behind registration and resampling:

- ``vtkImageReslice`` (reference structure/rigid.py:691-740,
  structure/image.py:160-215),
- SimpleITK ``DisplacementFieldTransform`` resample / DVF inversion
  (reference structure/deformable.py:732-774),
- ``scipy.ndimage.map_coordinates`` mesh warping
  (reference structure/deformable.py:961-1001),

and our own intensity-registration descent. Every function here runs on
:func:`ops.resample._trilinear`: taps clamp to the volume edge and
samples outside ``[0, dim-1]`` return ``background``. XLA fuses the
coordinate arithmetic, the 8 gathered taps and the lerp into one loop
fusion, so no coordinate volume is written for the displacement and
affine modes.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp

from .resample import _trilinear, _trilinear_parts

__all__ = ["base_grid", "field_warp", "coord_grads", "warp_disp",
           "make_warp_sampler", "make_disp_sampler", "affine_coords",
           "affine_warp"]


def base_grid(shape_zyx):
    """Broadcastable (zz, yy, xx) f32 output-grid coordinates."""
    Zo, Yo, Xo = shape_zyx
    zz = jnp.arange(Zo, dtype=jnp.float32)[:, None, None]
    yy = jnp.arange(Yo, dtype=jnp.float32)[None, :, None]
    xx = jnp.arange(Xo, dtype=jnp.float32)[None, None, :]
    return zz, yy, xx


def _batched(fn, vol, *args):
    """Apply ``fn(vol3d, *args)`` to a (Z, Y, X) volume or vmapped over
    the leading axis of a (B, Z, Y, X) stack sharing the coordinates."""
    vol = jnp.asarray(vol, jnp.float32)
    if vol.ndim == 3:
        return fn(vol, *args)
    return jax.vmap(fn, in_axes=(0,) + (None,) * len(args))(vol, *args)


def field_warp(vol, cz, cy, cx, background=0.0):
    """Trilinear-sample ``vol`` at absolute voxel coords (cz, cy, cx).

    vol : (Z, Y, X) or (B, Z, Y, X); every volume of a batch is sampled
    at the same (Zo, Yo, Xo) coordinates. Returns (Zo, Yo, Xo) or
    (B, Zo, Yo, Xo) float32."""
    coords = jnp.stack([jnp.asarray(cx, jnp.float32),
                        jnp.asarray(cy, jnp.float32),
                        jnp.asarray(cz, jnp.float32)], axis=-1)
    return _batched(_trilinear, vol, coords, jnp.float32(background))


def _coord_grads_single(vol, coords):
    _, res = _trilinear_parts(vol, coords, jnp.float32(0.0))
    c, fx, fy, fz, c00, c01, c10, c11, c0, c1, inside = res
    dx = ((c[1] - c[0]) * (1 - fy) + (c[3] - c[2]) * fy) * (1 - fz) \
        + ((c[5] - c[4]) * (1 - fy) + (c[7] - c[6]) * fy) * fz
    dy = (c01 - c00) * (1 - fz) + (c11 - c10) * fz
    dz = c1 - c0
    m = inside.astype(jnp.float32)
    return dz * m, dy * m, dx * m


def coord_grads(vol, cz, cy, cx):
    """Exact trilinear derivatives (d/dcz, d/dcy, d/dcx) of the sample,
    zero outside the volume; shapes as :func:`field_warp`."""
    coords = jnp.stack([cx, cy, cz], axis=-1)
    return _batched(_coord_grads_single, vol, coords)


def warp_disp(vols, disp, background=0.0):
    """Displacement warp: out(p) = vols(p + disp(p)).

    disp is the planar (3, Zo, Yo, Xo) voxel-displacement field with
    rows ordered (x, y, z); vols (Z, Y, X) or (B, Z, Y, X)."""
    disp = jnp.asarray(disp, jnp.float32)
    zz, yy, xx = base_grid(disp.shape[1:])
    return field_warp(vols, zz + disp[2], yy + disp[1], xx + disp[0],
                      background)


def make_warp_sampler(vol, background=0.0):
    """Differentiable sampler ``sample(cz, cy, cx) -> out`` with the
    exact analytic coordinate VJP (not differentiable w.r.t. the
    volume). vol (Z, Y, X) or (B, Z, Y, X); for a batch the coordinate
    cotangents sum over the batch."""
    vol = jnp.asarray(vol, jnp.float32)
    batched = vol.ndim == 4

    @jax.custom_vjp
    def sample(cz, cy, cx):
        return field_warp(vol, cz, cy, cx, background)

    def fwd(cz, cy, cx):
        return (field_warp(vol, cz, cy, cx, background),
                coord_grads(vol, cz, cy, cx))

    def bwd(res, g):
        grads = tuple(g * gc for gc in res)
        if batched:
            grads = tuple(jnp.sum(gc, axis=0) for gc in grads)
        return grads

    sample.defvjp(fwd, bwd)
    return sample


def make_disp_sampler(vol, background=0.0):
    """Differentiable DISPLACEMENT sampler ``sample(disp) -> out`` with
    the exact analytic VJP; disp is the planar (3, Zo, Yo, Xo) field of
    :func:`warp_disp`. The cotangent w.r.t. disp is the coordinate
    gradients stacked (x, y, z). Not differentiable w.r.t. the
    volume."""
    coord_sampler = make_warp_sampler(vol, background)

    def sample(disp):
        zz, yy, xx = base_grid(disp.shape[1:])
        return coord_sampler(zz + disp[2], yy + disp[1], xx + disp[0])

    return sample


def affine_coords(pixel_matrix, out_shape):
    """Materialize (cz, cy, cx) for an (x,y,z)-ordered 4x4 pixel matrix
    mapping output pixel (x, y, z, 1) -> input pixel, the convention of
    :func:`ops.resample.affine_resample`. Differentiable in the matrix."""
    A = jnp.asarray(pixel_matrix, jnp.float32)
    Zo, Yo, Xo = (int(s) for s in out_shape)
    zz, yy, xx = base_grid((Zo, Yo, Xo))
    cx = A[0, 0] * xx + A[0, 1] * yy + A[0, 2] * zz + A[0, 3]
    cy = A[1, 0] * xx + A[1, 1] * yy + A[1, 2] * zz + A[1, 3]
    cz = A[2, 0] * xx + A[2, 1] * yy + A[2, 2] * zz + A[2, 3]
    shape = (Zo, Yo, Xo)
    return (jnp.broadcast_to(cz, shape), jnp.broadcast_to(cy, shape),
            jnp.broadcast_to(cx, shape))


def affine_warp(volume, pixel_matrix, out_shape, background=0.0):
    """Affine resample of a (Z, Y, X) or (B, Z, Y, X) volume; same
    contract and result as :func:`ops.resample.affine_resample`."""
    cz, cy, cx = affine_coords(pixel_matrix, out_shape)
    return field_warp(volume, cz, cy, cx, background)
