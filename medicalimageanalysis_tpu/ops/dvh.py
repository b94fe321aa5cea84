"""Dose-volume-histogram reductions (device).

Device replacement for the reference's per-ROI numpy percentile /
binning loop (reference structure/dose.py:774-816): one jitted program
computes Dmin/Dmax/Dmean/Dmedian/Dstd, all D1..D99 percentiles, and the
VS{d}Gy percent/cc bins from a masked dose array — pure sorts and
reductions, trivially batchable over ROIs with vmap.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

__all__ = ["dvh_statistics", "count_below", "D_VALUES"]

D_VALUES = (1, 2, 5, 10, 15, 20, 25, 30, 35, 40, 45, 50, 55, 60, 65, 70,
            75, 80, 85, 90, 95, 98, 99)


@jax.jit
def count_below(dose, thresholds, valid=None):
    """Cumulative DVH counts: for every threshold t, the number of
    valid dose values < t (int32, exact). One sort plus a binary search
    per threshold; invalid values sort past every threshold."""
    dose = jnp.asarray(dose, jnp.float32).ravel()
    if valid is not None:
        dose = jnp.where(jnp.asarray(valid).ravel() > 0, dose, jnp.inf)
    return jnp.searchsorted(jnp.sort(dose),
                            jnp.asarray(thresholds, jnp.float32),
                            side="left").astype(jnp.int32)


@partial(jax.jit, static_argnames=("n_bins", "increment"))
def _dvh_core(dose, valid, d_percents, n_bins, increment):
    big = jnp.float32(3.4e38)
    n = jnp.sum(valid)
    vals = jnp.where(valid, dose, big)
    sorted_vals = jnp.sort(vals)  # valid values first, pads at the end

    dmin = sorted_vals[0]
    dmax = jnp.max(jnp.where(valid, dose, -big))
    s = jnp.sum(jnp.where(valid, dose, 0.0))
    mean = s / n
    var = jnp.sum(jnp.where(valid, (dose - mean) ** 2, 0.0)) / n

    def percentile(q):
        # numpy 'linear' interpolation on the valid prefix
        pos = q / 100.0 * (n - 1)
        lo = jnp.floor(pos).astype(jnp.int32)
        hi = jnp.ceil(pos).astype(jnp.int32)
        frac = pos - lo
        return sorted_vals[lo] * (1 - frac) + sorted_vals[hi] * frac

    median = percentile(jnp.float32(50.0))
    d_out = jax.vmap(percentile)(100.0 - d_percents)

    # VS bins: fraction / count of voxels with dose < d
    thresholds = jnp.arange(n_bins, dtype=jnp.float32) * increment
    below = jax.vmap(
        lambda t: jnp.sum(jnp.where(valid, (dose < t).astype(jnp.float32),
                                    0.0)))(thresholds)
    return dmin, dmax, mean, median, jnp.sqrt(var), d_out, below, n


def dvh_statistics(dose_in_roi, voxel_volume_cc, roi_name="",
                   max_dose=150, increment=5):
    """Full DVH dict matching the reference's keys
    (reference structure/dose.py:774-816)."""
    dose = np.asarray(dose_in_roi, dtype=np.float32).ravel()
    n = dose.size
    if n == 0:
        return {"ROI": roi_name, "Volume (cc)": 0.0}
    # pad to a bucket so jit caches few shapes
    b = 256
    while b < n:
        b *= 2
    padded = np.zeros(b, np.float32)
    padded[:n] = dose
    valid = np.zeros(b, bool)
    valid[:n] = True

    n_bins = max_dose // increment + 2
    dmin, dmax, mean, median, std, d_out, below, count = _dvh_core(
        jnp.asarray(padded), jnp.asarray(valid),
        jnp.asarray(np.asarray(D_VALUES, np.float32)), int(n_bins),
        float(increment))

    dvh = {"ROI": roi_name,
           "Volume (cc)": float(n * voxel_volume_cc),
           "Dmin": float(dmin), "Dmax": float(dmax),
           "Dmean": float(mean), "Dmedian": float(median),
           "Dstd": float(std)}
    d_out = np.asarray(d_out)
    for i, d in enumerate(D_VALUES):
        dvh[f"D{d}"] = float(d_out[i])
    below = np.asarray(below)
    for i in range(n_bins):
        d = i * increment
        if d > max_dose + increment:
            break
        dvh[f"VS{d}Gy_percent"] = float(below[i] / n * 100.0)
        dvh[f"VS{d}Gy_cc"] = float(below[i] * voxel_volume_cc)
    return dvh
