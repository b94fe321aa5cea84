"""Device polygon rasterization: contour -> 3D binary mask.

Device replacement for the reference's per-slice cv2.fillPoly + XOR
loop (reference utils/convert/contour.py:76-116). Semantics preserved:

- vertices truncated to int32 (the reference's ``astype(np.int32)``)
- each polygon fills interior + 8-connected Bresenham boundary (cv2's
  fillPoly convention)
- polygons on the same slice combine by XOR (hole handling)

Design (one fused XLA program, no per-slice host loop):
- per-row quantities per edge: the even-odd crossing position (interior)
  and the covered pixel run (8-connected boundary);
- accumulation over edges is a chunked broadcast-compare + reduce
  against the pixel axis (compare+reduce fuses; scatters would
  serialize: ~E/8 streaming passes over the (K, H, W) counters);
- per-slice XOR = parity of the per-polygon bitmap sum.

All shapes are static; polygons are padded to (K, E) buckets so jit
caches a small number of compilations.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["rasterize_polygons", "polygon_bitmaps", "fill_polygons_2d"]


def _bucket(n, minimum=8):
    b = minimum
    while b < n:
        b *= 2
    return b


def stage_polygons(polys, E, Kb, offsets=None):
    """The ONE staging of the cv2 vertex contract (shared by the
    full-frame path, the bbox-tile path and the sharded cohort path so
    the quantization can never drift between them): trunc(poly + 1e-6)
    -> int32 (idempotent for already-integer input), close each chain
    on its first vertex, pad to (Kb, E+1, 2) verts + (Kb, E)
    edge_valid. ``offsets``: optional per-polygon (x, y) int
    translation applied AFTER truncation (tile anchoring)."""
    verts = np.zeros((Kb, E + 1, 2), np.int32)
    valid = np.zeros((Kb, E), bool)
    for k, poly in enumerate(polys):
        p = np.trunc(np.asarray(poly)[:, :2] + 1e-6).astype(np.int32)
        if offsets is not None:
            p = p - offsets[k]
        n = p.shape[0]
        verts[k, :n] = p
        verts[k, n:] = p[0]
        valid[k, :n] = True
    return verts, valid


@partial(jax.jit, static_argnames=("H", "W"))
def _polygon_bitmaps(verts, edge_valid, H, W):
    """verts: (K, E+1, 2) int32 closed vertex chains (v[i], v[i+1]) edges;
    edge_valid: (K, E) bool. Returns (K, H, W) uint8 bitmaps."""
    K, E1, _ = verts.shape
    E = E1 - 1
    x1 = verts[:, :-1, 0].astype(jnp.float32)
    y1 = verts[:, :-1, 1].astype(jnp.float32)
    x2 = verts[:, 1:, 0].astype(jnp.float32)
    y2 = verts[:, 1:, 1].astype(jnp.float32)
    valid = edge_valid

    py = jnp.arange(H, dtype=jnp.float32)[None, None, :]       # (1,1,H)
    x1b = x1[:, :, None]
    y1b = y1[:, :, None]
    x2b = x2[:, :, None]
    y2b = y2[:, :, None]
    vb = valid[:, :, None]

    # ---- interior: even-odd crossings ------------------------------
    crosses = ((y1b > py) != (y2b > py)) & vb                   # (K,E,H)
    denom = jnp.where(y2b != y1b, y2b - y1b, 1.0)
    x_int = x1b + (py - y1b) * (x2b - x1b) / denom
    # px < x_int  <=>  px <= ceil(x_int) - 1; crossing bin = ceil(x_int)
    cross_bin = jnp.clip(jnp.ceil(x_int), 0, W).astype(jnp.int32)
    # bin 0 contributes nothing under the px < bin test -> no-op value
    cross_bin = jnp.where(crosses, cross_bin, 0)                # (K,E,H)

    # ---- boundary: 8-connected line coverage ------------------------
    # cv2's fixed-point scan rounds half DOWN (x_screen =
    # (x + 2^15 - 1) >> 16), so screen_y(x) == py <=> y(x) in
    # (py-0.5, py+0.5]. EPS implements the open/closed ends for the
    # exact half-integer crossings that integer vertices produce.
    EPS = 1e-3
    dx = x2b - x1b
    dy = y2b - y1b
    shallow = jnp.abs(dx) >= jnp.abs(dy)

    # shallow: pixels x with screen_y(x) == py form a contiguous run.
    # x(y) = x1 + (y - y1) * dx/dy; slope sign decides which end is open.
    sdy = jnp.where(dy != 0, dy, 1.0)
    t_m = x1b + (py - 0.5 - y1b) * dx / sdy   # x at y = py - 0.5
    t_p = x1b + (py + 0.5 - y1b) * dx / sdy   # x at y = py + 0.5
    # cv2's fixed-point tie rule, probed over both slope signs and
    # both directions (concave-star regression): positive slope puts
    # the exact half-integer crossing in the LOWER row, negative slope
    # in the UPPER — both cases reduce to "x-run open at min(t),
    # closed at max(t)". The old both-ends-closed rule leaked one
    # pixel per tie outside concave corners.
    lo_sl = jnp.ceil(jnp.minimum(t_m, t_p) + EPS)
    hi_sl = jnp.floor(jnp.maximum(t_m, t_p) + EPS)
    # dy == 0: whole x-range when the row matches exactly
    row_match = jnp.abs(py - y1b) < 0.5
    lo_sh = jnp.where(dy != 0, lo_sl,
                      jnp.where(row_match, -jnp.inf, jnp.inf))
    hi_sh = jnp.where(dy != 0, hi_sl,
                      jnp.where(row_match, jnp.inf, -jnp.inf))
    xmin = jnp.minimum(x1b, x2b)
    xmax = jnp.maximum(x1b, x2b)
    lo_sh = jnp.maximum(lo_sh, xmin)
    hi_sh = jnp.minimum(hi_sh, xmax)

    # steep: one pixel per row: x = round_half_down(x(py)),
    # rows py in [ymin, ymax]
    x_at = x1b + (py - y1b) * dx / sdy
    xs = jnp.floor(x_at + 0.5 - EPS)
    ymin = jnp.minimum(y1b, y2b)
    ymax = jnp.maximum(y1b, y2b)
    in_rows = (py >= ymin) & (py <= ymax)
    lo_st = jnp.where(in_rows, xs, 1.0)
    hi_st = jnp.where(in_rows, xs, 0.0)

    lo = jnp.where(shallow, lo_sh, lo_st)
    hi = jnp.where(shallow, hi_sh, hi_st)
    run = vb & (hi >= lo)
    lo_c = jnp.clip(lo, 0, W).astype(jnp.int32)
    hi_c = jnp.clip(hi + 1, 0, W + 1).astype(jnp.int32)  # exclusive end
    ok = run & (hi >= 0) & (lo <= W - 1)
    lo_c = jnp.where(ok, lo_c, W + 2)                    # empty run
    hi_c = jnp.where(ok, hi_c, 0)

    # ---- accumulate over edges: fused compare+reduce (no scatter) ----
    # scatters serialize; a per-edge fold (round-1 design) kept the
    # whole (K, H, W) carry in HBM and re-read/re-wrote it E times. Here
    # edges reduce in CHUNKS: inside a chunk the (K, C, H, W) compare is
    # a virtual fusion operand of the sum/any reduce — XLA keeps the
    # accumulator in registers per output tile — so the carry maps are
    # touched only E/C times (C=128: two orders of magnitude less HBM
    # traffic, same compares).
    px = jnp.arange(W, dtype=jnp.int32)[None, None, None, :]  # (1,1,1,W)
    C = min(128, E)

    def body(carry, xs):
        par, cov = carry
        cb, lo_e, hi_e = xs                              # each (C, K, H)
        cb = jnp.moveaxis(cb, 0, 1)[..., None]           # (K, C, H, 1)
        lo_b = jnp.moveaxis(lo_e, 0, 1)[..., None]
        hi_b = jnp.moveaxis(hi_e, 0, 1)[..., None]
        n_cross = jnp.sum((px < cb).astype(jnp.int32), axis=1)
        inrun = jnp.any((px >= lo_b) & (px < hi_b), axis=1)
        return (par ^ (n_cross & 1).astype(bool), cov | inrun), None

    init = (jnp.zeros((K, H, W), bool), jnp.zeros((K, H, W), bool))
    xs = (jnp.moveaxis(cross_bin, 1, 0).reshape(E // C, C, K, H),
          jnp.moveaxis(lo_c, 1, 0).reshape(E // C, C, K, H),
          jnp.moveaxis(hi_c, 1, 0).reshape(E // C, C, K, H))
    (interior, boundary), _ = lax.scan(body, init, xs)

    return (interior | boundary).astype(jnp.uint8)


@partial(jax.jit, static_argnames=("n_slices",))
def _scatter_xor(bitmaps, slice_idx, n_slices):
    H, W = bitmaps.shape[1], bitmaps.shape[2]
    acc = jnp.zeros((n_slices + 1, H, W), dtype=jnp.uint8)
    acc = acc.at[slice_idx].add(bitmaps)
    return (acc[:n_slices] % 2).astype(jnp.uint8)


# ------------------------------------------------------------------ #
# bbox-tile path: each polygon rasterizes only its own tile           #
# ------------------------------------------------------------------ #
# The full-frame kernel pays K x E x H x W compares even though a
# typical contour spans a fraction of the slice (a liver contour's
# ~170 px bbox on a 512 grid wastes ~9x). Polygons are classed by
# bbox size into this power-of-two ladder, rasterized tile-locally,
# and composed by K sequential dynamic-slice adds (cheap: each is one
# tile, and parity survives uint8 wraparound).
_TILE_LADDER = (16, 32, 64, 128, 256)


@partial(jax.jit, donate_argnums=(0,))
def _compose_tiles(canvas, tiles, rows, ays, axs):
    """canvas[(rows[k], ays[k]:, axs[k]:)] += tiles[k] for every k,
    sequentially (tiles overlap; parity needs exact counts mod 2,
    which uint8 addition preserves)."""
    th, tw = tiles.shape[1], tiles.shape[2]

    def body(k, cv):
        cur = lax.dynamic_slice(cv, (rows[k], ays[k], axs[k]),
                                (1, th, tw))
        return lax.dynamic_update_slice(
            cv, cur + tiles[k][None], (rows[k], ays[k], axs[k]))

    return lax.fori_loop(0, tiles.shape[0], body, canvas)


def _pooled_canvas(polygons, targets, n_rows, H, W):
    """Rasterize ALL polygons (across slices / ROIs / volumes) into a
    (n_rows, H, W) uint8 parity canvas in one device pass per tile
    class. ``targets`` is each polygon's canvas row; out-of-range
    values must already be mapped to the dump row ``n_rows``. Returns
    the device canvas (parity taken, dump row dropped)."""
    K = len(polygons)
    trunc = [np.trunc(np.asarray(p)[:, :2] + 1e-6).astype(np.int32)
             for p in polygons]
    lo = np.array([p.min(axis=0) for p in trunc], np.int64)  # (K,2) x,y
    hi = np.array([p.max(axis=0) for p in trunc], np.int64)
    size = (hi - lo).max(axis=1) + 1

    classes = {}
    for k in range(K):
        for t in _TILE_LADDER:
            if size[k] <= t and t <= max(H, W):
                classes.setdefault(t, []).append(k)
                break
        else:
            classes.setdefault(0, []).append(k)  # full frame

    canvas = jnp.zeros((int(n_rows) + 1, H, W), jnp.uint8)
    targets = np.asarray(targets, np.int32)
    for t, ks in sorted(classes.items()):
        th = H if t == 0 else min(t, H)
        tw = W if t == 0 else min(t, W)
        ay = np.clip(lo[ks, 1], 0, max(H - th, 0)).astype(np.int32)
        ax = np.clip(lo[ks, 0], 0, max(W - tw, 0)).astype(np.int32)
        Kc = len(ks)
        E = _bucket(max(trunc[k].shape[0] for k in ks))
        # K buckets: multiples of 8 up to 64, then of 64 (bounds the
        # jit-variant count without the up-to-2x waste of power-of-2)
        Kb = -(-Kc // 8) * 8 if Kc <= 64 else -(-Kc // 64) * 64
        verts, valid = stage_polygons(
            [trunc[k] for k in ks], E, Kb,
            offsets=np.stack([ax, ay], axis=1))
        tiles = _polygon_bitmaps(jnp.asarray(verts), jnp.asarray(valid),
                                 th, tw)
        rows = np.full(Kb, int(n_rows), np.int32)
        rows[:Kc] = targets[ks]
        ays = np.zeros(Kb, np.int32)
        axs = np.zeros(Kb, np.int32)
        ays[:Kc] = ay
        axs[:Kc] = ax
        canvas = _compose_tiles(canvas, tiles, jnp.asarray(rows),
                                jnp.asarray(ays), jnp.asarray(axs))
    return (canvas[:n_rows] & 1).astype(jnp.uint8)


def _polygon_bitmaps_device(polygons, H, W):
    """(K-padded device bitmaps, K): stage polygons into (Kb, E) buckets
    and run the fused bitmap program; the result STAYS on device (rows
    k >= K are all-zero padding)."""
    K = len(polygons)
    E = _bucket(max(p.shape[0] for p in polygons))
    Kb = _bucket(K, minimum=1)
    verts, edge_valid = stage_polygons(polygons, E, Kb)
    out = _polygon_bitmaps(jnp.asarray(verts), jnp.asarray(edge_valid),
                           H, W)
    return out, K


def polygon_bitmaps(polygons, H, W):
    """Host wrapper: list of (N, 2) float vertex arrays -> (K, H, W)
    uint8 filled bitmaps (interior + boundary)."""
    if len(polygons) == 0:
        return np.zeros((0, H, W), dtype=np.uint8)
    out, K = _polygon_bitmaps_device(polygons, H, W)
    # slice on HOST: a device out[:K] is an eager op that compiles a new
    # executable for every distinct polygon count; the padded rows are
    # all-zero and compress to ~nothing in transfer
    return np.asarray(out)[:K]


def fill_polygons_2d(polygons, H, W):
    """XOR-combine polygons into one 2D mask (cv2.fillPoly + XOR loop
    equivalent for a single plane)."""
    bitmaps = polygon_bitmaps(polygons, H, W)
    if bitmaps.shape[0] == 0:
        return np.zeros((H, W), dtype=np.uint8)
    return (bitmaps.sum(axis=0) % 2).astype(np.uint8)


def rasterize_polygons(polygons, slice_indices, n_slices, H, W):
    """Full 3D rasterization: polygons (list of (N,2)) at slice_indices
    -> (n_slices, H, W) uint8 mask with per-slice XOR semantics.

    Rides the bbox-tile path: each polygon rasterizes only its own
    power-of-two tile and K dynamic-slice adds compose the canvas —
    ~an order of magnitude less work than the old full-frame
    kernel at liver scale (bbox ~170 px on a 512 grid)."""
    K = len(polygons)
    if K == 0:
        return np.zeros((n_slices, H, W), dtype=np.uint8)
    ids = np.asarray(slice_indices, dtype=np.int32)
    # out-of-range (including NEGATIVE) slices -> dump row, matching the
    # cv2 backend's `if 0 <= s < S` drop (round-2 review finding: a
    # clip-to-0 XORed below-volume contours into slice 0)
    targets = np.where((ids >= 0) & (ids < n_slices), ids, n_slices)
    out = _pooled_canvas(polygons, targets, int(n_slices), int(H),
                         int(W))
    return np.asarray(out)


def rasterize_polygons_grouped(grouped, n_slices, H, W):
    """Cohort rasterization: ``grouped`` is a list over ROIs/volumes of
    (polygons, slice_indices) pairs on a SHARED (n_slices, H, W) grid.
    ALL contours of ALL groups run in ONE device pass per tile class
    (the canvas rows are (group, slice) pairs), so a whole patient's
    structure set costs one dispatch. Returns (B, n_slices, H, W)
    uint8."""
    B = len(grouped)
    S = int(n_slices)
    pool = []
    targets = []
    for b, (polys, sids) in enumerate(grouped):
        ids = np.asarray(sids, dtype=np.int32)
        ok = (ids >= 0) & (ids < S)
        pool.extend(polys)
        targets.extend(np.where(ok, b * S + ids, B * S).tolist())
    if not pool:
        return np.zeros((B, S, H, W), dtype=np.uint8)
    out = _pooled_canvas(pool, np.asarray(targets, np.int32), B * S,
                         int(H), int(W))
    return np.asarray(out).reshape(B, S, int(H), int(W))
