"""Exact Euclidean distance transform + surface-distance QA on device.

BEYOND-PARITY device twin of the scipy EDT paths (utils/roi/margin.py,
utils/metrics.py): the host framework drops to
``scipy.ndimage.distance_transform_edt`` + a cKDTree for margins and
surface metrics, which caps QA at one-pair-at-a-time host throughput.
This module computes the exact anisotropic EDT with XLA, which makes
Dice/HD95/ASSD/surface-Dice panels jit-able, vmappable over cohort
batches and shardable over the ('data',) mesh axis
(parallel/batch.compare_masks_batch).

Algorithm: the separable exact squared EDT. Along each axis the 1-D
transform is the min-plus convolution

    out[i] = min_j  in[j] + (s * (i - j))**2

evaluated brute-force (O(L^2) per line). The classic O(L)
lower-envelope algorithm (Felzenszwalb-Huttenlocher) is inherently
sequential with a data-dependent stack — hostile to XLA — while the
min-plus form is a dense broadcast+reduce XLA fuses: for clinical
volumes (L <= 512) the arithmetic is ~L^2 * lines * 3 axes ~ 1e10-1e11
fused flops. Exactness is
inherited from separability: each pass takes squared distances from
the previous pass, so the final value is the true
min over feature voxels of sum_axis (s_axis * delta_axis)^2 (same
decomposition scipy's implementation uses).

Conventions (package-wide): arrays are (..., Z, Y, X); ``spacing`` is
[sx, sy, sz] mm. "Feature" voxels are True; the transform returns the
distance from every voxel to the nearest feature voxel (zero on the
features themselves). ``distance_transform`` mirrors scipy's calling
convention (distance from nonzero voxels to the nearest ZERO voxel).

Boundary extraction matches utils/metrics._boundary_points_mm:
scipy.ndimage.binary_erosion's default cross structuring element with
border_value=0, so mask voxels on the array edge count as boundary.
"""

from __future__ import annotations

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax

__all__ = ["edt", "squared_edt", "distance_transform", "boundary_mask",
           "masked_percentile", "surface_metrics", "BIG_D2"]

# Squared-mm "infinity". Real squared distances top out around
# 3 * (512 voxels * 5 mm)^2 ~ 2e7, four decades below; float32 keeps
# BIG_D2 + w == BIG_D2 for every reachable parabola weight, so
# feature-free lines stay saturated until a later axis pass finds a
# feature in another line.
BIG_D2 = np.float32(1e10)

_CHUNK = 8  # output rows per lax.map step in the 1-D transform


def _edt_1d_lastaxis(d2, step):
    """One separable pass along the LAST axis.

    d2: (..., L) float32 squared distances from the previous pass;
    step: static mm-per-index along this axis. Returns same shape.
    """
    L = d2.shape[-1]
    lead = d2.shape[:-1]
    flat = d2.reshape(-1, L)  # (M, L)
    idx = jnp.arange(L, dtype=jnp.float32) * jnp.float32(step)
    # w[i, j] = (s*(i-j))^2 — parabola weights, (L, L)
    w = (idx[:, None] - idx[None, :]) ** 2
    n_chunks = -(-L // _CHUNK)
    pad = n_chunks * _CHUNK - L
    if pad:
        # padded output rows are sliced away below; their weights are
        # arbitrary (reuse row 0)
        w = jnp.concatenate([w, jnp.broadcast_to(w[:1], (pad, L))], axis=0)
    w_chunks = w.reshape(n_chunks, _CHUNK, L)

    def one_chunk(wc):
        # (M, 1, L) + (ci, L) -> reduce over j -> (M, ci); XLA fuses
        # the broadcast-add into the reduction so the (M, ci, L)
        # intermediate never materializes
        return jnp.min(flat[:, None, :] + wc[None, :, :], axis=-1)

    out = lax.map(one_chunk, w_chunks)          # (n_chunks, M, ci)
    out = jnp.moveaxis(out, 0, 1).reshape(flat.shape[0], n_chunks * _CHUNK)
    return out[:, :L].reshape(*lead, L)


@partial(jax.jit, static_argnames=("spacing",))
def squared_edt(feature, spacing=(1.0, 1.0, 1.0)):
    """Exact squared EDT in mm^2 over the trailing (Z, Y, X) axes.

    feature: bool-ish (..., Z, Y, X), True = feature set;
    spacing: static [sx, sy, sz]. Voxels with no feature anywhere in
    the volume saturate at BIG_D2 (see ``edt`` for the inf mapping).
    """
    f = jnp.asarray(feature)
    if f.dtype != jnp.bool_:
        f = f > 0
    sx, sy, sz = (float(v) for v in spacing)
    d2 = jnp.where(f, jnp.float32(0), BIG_D2)
    d2 = _edt_1d_lastaxis(d2, sx)                       # x (last)
    d2 = jnp.swapaxes(
        _edt_1d_lastaxis(jnp.swapaxes(d2, -1, -2), sy), -1, -2)  # y
    d2 = jnp.moveaxis(
        _edt_1d_lastaxis(jnp.moveaxis(d2, -3, -1), sz), -1, -3)  # z
    return d2


def edt(feature, spacing=(1.0, 1.0, 1.0)):
    """Exact EDT in mm: distance from every voxel to the nearest True
    voxel (0 on features; +inf when the volume has no features)."""
    spacing = tuple(float(v) for v in np.asarray(spacing).reshape(-1))
    d2 = squared_edt(feature, spacing)
    return jnp.where(d2 >= BIG_D2 * 0.5, jnp.inf, jnp.sqrt(d2))


def distance_transform(mask, spacing=(1.0, 1.0, 1.0)):
    """scipy.ndimage.distance_transform_edt semantics: distance from
    each NONZERO voxel to the nearest zero voxel (zeros map to 0)."""
    m = jnp.asarray(mask)
    if m.dtype != jnp.bool_:
        m = m > 0
    return edt(~m, spacing)


@jax.jit
def boundary_mask(mask):
    """Surface voxels: mask minus its cross-structured erosion with a
    ZERO border (scipy binary_erosion defaults — array-edge mask
    voxels are boundary). (..., Z, Y, X) bool in, bool out."""
    m = jnp.asarray(mask)
    if m.dtype != jnp.bool_:
        m = m > 0
    eroded = m

    def axis_neighbors_min(x, axis):
        lo = jnp.concatenate(
            [jnp.zeros_like(lax.slice_in_dim(x, 0, 1, axis=axis)),
             lax.slice_in_dim(x, 0, x.shape[axis] - 1, axis=axis)],
            axis=axis)
        hi = jnp.concatenate(
            [lax.slice_in_dim(x, 1, x.shape[axis], axis=axis),
             jnp.zeros_like(lax.slice_in_dim(x, 0, 1, axis=axis))],
            axis=axis)
        return lo & hi

    for ax in (-3, -2, -1):
        eroded = eroded & axis_neighbors_min(m, ax)
    return m & ~eroded


def _float_keys(vals_f32):
    """Monotonic uint32 key for the FULL f32 line (the radix-sort key
    transform): negatives bit-flip entirely, non-negatives set the
    sign bit, so unsigned key compare == float compare with
    -inf < ... < -0.0 < +0.0 < ... < +inf."""
    u = lax.bitcast_convert_type(vals_f32, jnp.uint32)
    return jnp.where(u >> 31 != 0, ~u, u | jnp.uint32(0x80000000))


def _key_to_float(key):
    u = jnp.where(key >> 31 != 0, key & jnp.uint32(0x7FFFFFFF), ~key)
    return lax.bitcast_convert_type(u, jnp.float32)


def _order_stat(keys, valid, rank):
    """Exact ``rank``-th smallest (1-indexed) uint32 key among the
    valid entries. Binary search over the key range: 32 fused
    masked-count passes instead of a full sort (the sort was the
    surface-panel hot spot; the counts are streaming passes).
    Returns the key;
    it is always one actually present (counts only change at present
    keys)."""
    target = rank

    def body(_, lohi):
        lo, hi = lohi
        mid = lo + (hi - lo) // 2  # (lo + hi) would overflow
        c = jnp.sum(jnp.where(valid, keys <= mid, False))
        take = c >= target
        return (jnp.where(take, lo, mid + jnp.uint32(1)),
                jnp.where(take, mid, hi))

    lo = jnp.uint32(0)
    hi = jnp.uint32(0xFFFFFFFF)
    lo, hi = lax.fori_loop(0, 32, body, (lo, hi))
    return hi


def masked_percentile(values, valid, q):
    """np.percentile(values[valid], q) with 'linear' interpolation,
    jit-safe (static shapes), for ANY f32 values (negatives and
    +-inf included — the order statistics come from a bit-level
    binary search over the monotonic radix key, exact and sort-free).
    valid: same-shape bool; q in [0, 100]. Returns nan when valid is
    empty or any valid value is NaN (numpy's nan-poisoning)."""
    vals = jnp.asarray(values, jnp.float32).ravel()
    vmask = jnp.asarray(valid).ravel()
    keys = _float_keys(vals)
    n = jnp.sum(vmask)
    pos = jnp.float32(q) / 100.0 * jnp.maximum(n - 1, 0).astype(jnp.float32)
    lo = jnp.floor(pos).astype(jnp.int32)
    hi = jnp.ceil(pos).astype(jnp.int32)
    frac = pos - lo.astype(jnp.float32)
    k_lo = _order_stat(keys, vmask, lo + 1)
    v_lo = _key_to_float(k_lo)
    # ranks lo+1 and hi+1 differ by at most one, so the second order
    # statistic needs no second 32-pass search: if duplicates of v_lo
    # already cover rank hi+1 it IS v_lo, else it is the smallest
    # valid key strictly above k_lo — two streaming passes
    c_lo = jnp.sum(jnp.where(vmask, keys <= k_lo, False))
    k_next = jnp.min(jnp.where(vmask & (keys > k_lo), keys,
                               jnp.uint32(0xFFFFFFFF)))
    v_hi = jnp.where(c_lo >= hi + 1, v_lo, _key_to_float(k_next))
    # frac == 0 must return v_lo verbatim: v_hi can be +inf (e.g.
    # q=100 on a set containing inf) and inf * 0 would NaN the result
    val = jnp.where(frac > 0, v_lo * (1.0 - frac) + v_hi * frac, v_lo)
    bad = jnp.any(vmask & jnp.isnan(vals))
    return jnp.where((n > 0) & ~bad, val, jnp.nan)


def surface_metrics(mask_a, mask_b, spacing=(1.0, 1.0, 1.0),
                    tolerance_mm=2.0):
    """Full segmentation-QA panel on device, matching the host
    utils/metrics panel (KD-tree between boundary voxel centers):
    the EDT of each mask's boundary set sampled at the other mask's
    boundary voxels IS the exact nearest-neighbor distance between
    voxel-center point sets.

    Returns a dict of f32 scalars: dice, jaccard, volume_a_cc,
    volume_b_cc, hausdorff_mm, hd95_mm, assd_mm, surface_dice
    (@tolerance). Surface stats are nan when either mask is empty
    (matching the host panel, which omits them).
    """
    sp = tuple(float(v) for v in np.asarray(spacing).reshape(-1))
    return _surface_metrics_jit(mask_a, mask_b, sp, float(tolerance_mm))


@partial(jax.jit, static_argnames=("spacing", "tolerance_mm"))
def _surface_metrics_jit(mask_a, mask_b, spacing, tolerance_mm):
    sp = spacing
    a = jnp.asarray(mask_a)
    a = a > 0 if a.dtype != jnp.bool_ else a
    b = jnp.asarray(mask_b)
    b = b > 0 if b.dtype != jnp.bool_ else b

    na = jnp.sum(a).astype(jnp.float32)
    nb = jnp.sum(b).astype(jnp.float32)
    inter = jnp.sum(a & b).astype(jnp.float32)
    union = jnp.sum(a | b).astype(jnp.float32)
    vox_cc = jnp.float32(np.prod(sp) / 1000.0)
    dice = jnp.where(na + nb > 0, 2.0 * inter / (na + nb), 1.0)
    jac = jnp.where(union > 0, inter / union, 1.0)

    ba = boundary_mask(a)
    bb = boundary_mask(b)
    d_to_b = edt(bb, sp)   # distance field to b's surface
    d_to_a = edt(ba, sp)
    # directed distance samples (masked full-grid fields)
    n_ba = jnp.sum(ba).astype(jnp.float32)
    n_bb = jnp.sum(bb).astype(jnp.float32)
    sum_ab = jnp.sum(jnp.where(ba, d_to_b, 0.0))
    sum_ba = jnp.sum(jnp.where(bb, d_to_a, 0.0))
    assd = (sum_ab + sum_ba) / jnp.maximum(n_ba + n_bb, 1.0)
    hits = (jnp.sum(jnp.where(ba, d_to_b <= tolerance_mm, False))
            + jnp.sum(jnp.where(bb, d_to_a <= tolerance_mm, False))
            ).astype(jnp.float32)
    sdice = hits / jnp.maximum(n_ba + n_bb, 1.0)
    hd = jnp.maximum(jnp.max(jnp.where(ba, d_to_b, -jnp.inf)),
                     jnp.max(jnp.where(bb, d_to_a, -jnp.inf)))
    hd95 = jnp.maximum(masked_percentile(d_to_b, ba, 95.0),
                       masked_percentile(d_to_a, bb, 95.0))

    both = (na > 0) & (nb > 0)
    nan = jnp.float32(jnp.nan)
    return {
        "dice": dice, "jaccard": jac,
        "volume_a_cc": na * vox_cc, "volume_b_cc": nb * vox_cc,
        "hausdorff_mm": jnp.where(both, hd, nan),
        "hd95_mm": jnp.where(both, hd95, nan),
        "assd_mm": jnp.where(both, assd, nan),
        "surface_dice": jnp.where(both, sdice, nan),
    }
