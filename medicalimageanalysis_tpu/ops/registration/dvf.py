"""Displacement-vector-field primitives.

Device replacements for the SimpleITK DVF machinery the reference
uses (reference structure/deformable.py:732-774):

- :func:`warp_volume` — DisplacementFieldTransform + Resample:
  out(x) = vol(x + d(x)) with d in physical mm on the output grid.
- :func:`invert_dvf` — InvertDisplacementFieldImageFilter: fixed-point
  iteration v <- -d(x + v(x)).
- :func:`compose_dvf` — field composition (u after v).
- :func:`gradient_magnitude` — sitk.GradientMagnitude equivalent
  (cross-modality correction, reference utils/deformable/simpleitk.py:48).

Public fields are (Z, Y, X, 3) arrays with mm components in (x, y, z)
order, matching the DICOM/ITK convention the reference stores
(reference read/dicom.py:1766-1786). INTERNALLY the iterations keep the
field planar (3, Z, Y, X) and feed it straight to the displacement warp
(``ops.warp.warp_disp``): no per-iteration channel transposes.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from ..warp import warp_disp

__all__ = ["warp_volume", "invert_dvf", "compose_dvf",
           "gradient_magnitude", "sample_dvf_at_points"]


@jax.jit
def _warp(vol, dvf_vox, background):
    """vol (Z,Y,X); dvf_vox (Z,Y,X,3) displacement in voxels (x,y,z)."""
    return warp_disp(vol, jnp.moveaxis(dvf_vox, -1, 0), background)


def warp_volume(volume, dvf_mm, spacing_xyz, background=0.0):
    """Warp: out(x) = volume(x + d(x)); d in mm on the same grid."""
    vol = jnp.asarray(volume, dtype=jnp.float32)
    dvf = jnp.asarray(dvf_mm, dtype=jnp.float32)
    sp = jnp.asarray(spacing_xyz, dtype=jnp.float32)
    return _warp(vol, dvf / sp, jnp.float32(background))


@partial(jax.jit, static_argnames=("iterations",))
def _invert_planar(field_b, iterations):
    """field_b: (3, Z, Y, X) planar voxel displacements (x, y, z) rows."""
    return jax.lax.fori_loop(
        0, iterations, lambda _, v: -warp_disp(field_b, v, 0.0), -field_b)


def invert_dvf(dvf_mm, spacing_xyz, iterations=20):
    """Fixed-point DVF inversion: returns v with (id + v) ~ (id + d)^-1."""
    dvf = np.asarray(dvf_mm, dtype=np.float32)
    sp = np.asarray(spacing_xyz, dtype=np.float32)
    field_b = jnp.asarray(np.moveaxis(dvf / sp, -1, 0))    # (3, Z, Y, X)
    out = _invert_planar(field_b, int(iterations))
    return np.moveaxis(np.asarray(out), 0, -1) * sp


@jax.jit
def _compose_planar(u_b, v_b):
    """(u after v)(x) = u(x + v(x)) + v(x); planar (3, Z, Y, X) fields."""
    return warp_disp(u_b, v_b, 0.0) + v_b


def compose_dvf(u_mm, v_mm, spacing_xyz):
    """Compose two mm fields on the same grid: (u after v)."""
    sp = np.asarray(spacing_xyz, dtype=np.float32)
    u_b = np.moveaxis(np.asarray(u_mm, np.float32) / sp, -1, 0)
    v_b = np.moveaxis(np.asarray(v_mm, np.float32) / sp, -1, 0)
    out = _compose_planar(jnp.asarray(u_b), jnp.asarray(v_b))
    return np.moveaxis(np.asarray(out), 0, -1) * sp


@jax.jit
def _grad_mag(vol, sp):
    gz, gy, gx = jnp.gradient(vol)
    return jnp.sqrt((gx / sp[0]) ** 2 + (gy / sp[1]) ** 2
                    + (gz / sp[2]) ** 2)


def gradient_magnitude(volume, spacing_xyz=(1.0, 1.0, 1.0)):
    """sitk.GradientMagnitude equivalent (central differences / spacing)."""
    return _grad_mag(jnp.asarray(volume, dtype=jnp.float32),
                     jnp.asarray(spacing_xyz, dtype=jnp.float32))


def sample_dvf_at_points(dvf_mm, points, origin, spacing_xyz,
                         mode_nearest=True):
    """Trilinear-sample the field at physical points (mesh warping,
    reference structure/deformable.py:961-1001 map_coordinates path)."""
    from ..resample import trilinear_gather

    pts = np.asarray(points, dtype=np.float64)
    voxel = (pts - np.asarray(origin)) / np.asarray(spacing_xyz)
    if mode_nearest:
        shape = dvf_mm.shape[:3]
        voxel = np.clip(voxel, 0, [shape[2] - 1, shape[1] - 1,
                                   shape[0] - 1])
    out = np.zeros_like(pts)
    for c in range(3):
        out[:, c] = np.asarray(trilinear_gather(
            dvf_mm[..., c], voxel.astype(np.float32), background=0.0))
    return out
