"""Device-side volume assembly kernels.

Device replacement for the reference's host-side per-slice loop
(reference read/dicom.py:509-534 `_compute_array`) and whole-volume
numpy moves (`_verify_axial_orientation`, read/dicom.py:655-740): the raw
slice stack is moved to device once, and rescale + int16 cast + FFS
reorientation run as one fused XLA program. The *decision* of which FFS
op applies is host metadata work (ops/geometry.ffs_decision); the *move*
happens here under jit with a static op-code, so XLA fuses it with the
rescale into a single pass over HBM.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

__all__ = ["apply_ffs", "assemble_volume", "assemble_volume_numpy"]


def apply_ffs(array, op):
    """jnp counterpart of geometry.apply_ffs_numpy (static op under jit)."""
    if op == "none":
        return array
    if op == "ax_rot1":
        return jnp.rot90(array, 1, (1, 2))
    if op == "ax_rot3":
        return jnp.rot90(array, 3, (1, 2))
    if op == "ax_rot2":
        return jnp.rot90(array, 2, (1, 2))
    if op == "cor_rot1":
        return jnp.rot90(array, 1, (0, 1))
    if op == "sag_fix":
        return jnp.flip(jnp.transpose(jnp.rot90(array, 1, (0, 1)), (0, 2, 1)),
                        axis=2)
    raise ValueError(f"unknown ffs op {op!r}")


@partial(jax.jit, static_argnames=("op", "out_dtype"))
def _assemble_jit(raw, slope, intercept, op, out_dtype):
    vol = raw.astype(jnp.float32) * slope[:, None, None] \
        + intercept[:, None, None]
    vol = vol.astype(out_dtype)
    return apply_ffs(vol, op)


def assemble_volume(raw_slices, slopes, intercepts, ffs_op="none",
                    out_dtype=np.int16):
    """Fused rescale (slope/intercept) -> int16 -> FFS reorientation.

    Parameters
    ----------
    raw_slices : (N, R, C) numpy array of stored pixel values
    slopes, intercepts : (N,) per-slice rescale
    ffs_op : op-code from geometry.ffs_decision
    """
    raw = jnp.asarray(raw_slices)
    slope = jnp.asarray(np.asarray(slopes, dtype=np.float32))
    intercept = jnp.asarray(np.asarray(intercepts, dtype=np.float32))
    out = _assemble_jit(raw, slope, intercept, ffs_op, jnp.dtype(out_dtype))
    return np.asarray(out)


def assemble_volume_numpy(raw_slices, slopes, intercepts, ffs_op="none",
                          out_dtype=np.int16):
    """Pure-numpy twin of assemble_volume (golden path for parity tests)."""
    from .geometry import apply_ffs_numpy

    slopes = np.asarray(slopes, dtype=np.float32)
    intercepts = np.asarray(intercepts, dtype=np.float32)
    raw = np.asarray(raw_slices)
    # integer fast path: the common CT case (slope 1, one integral
    # intercept) is exact in int16 and skips the 2x f32 round trip —
    # identical output (f32 is exact for all int16-range values)
    if (raw.dtype in (np.int16, np.uint16)
            and np.all(slopes == 1.0)
            and np.all(intercepts == intercepts[0])
            and float(intercepts[0]).is_integer()):
        vol = raw.astype(out_dtype, copy=True)
        if intercepts[0]:
            vol += out_dtype(int(intercepts[0]))
        return np.ascontiguousarray(apply_ffs_numpy(vol, ffs_op))
    vol = (raw.astype(np.float32) * slopes[:, None, None]
           + intercepts[:, None, None]).astype(out_dtype)
    return np.ascontiguousarray(apply_ffs_numpy(vol, ffs_op))
