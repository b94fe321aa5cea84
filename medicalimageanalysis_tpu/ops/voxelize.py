"""Device mesh voxelization by ray-casting parity.

The device twin of ``utils.convert.voxelize`` (exact Jordan-parity
fill through voxel centers; reference ``ModelToMask``'s plane-cut +
fillPoly is the workload it replaces, utils/convert/contour.py:331-461).
The host version is ragged (per-triangle integer-bbox candidate rays);
the device formulation makes every stage static-shaped:

1. triangles are classed by bbox size into power-of-two windows
   (almost all marching-cubes/decimated faces span <= 4 px), and each
   (triangle, window pixel) evaluates one barycentric ray test —
   local window coordinates keep f32 exact well inside the
   generic-position epsilons;
2. every hit emits ONE int32 key addressing a (column, k) bin of a
   histogram CROPPED to the mesh's padded bounding box (the crossing
   flips all centers k <= k_max in its column); misses emit a
   sentinel;
3. a uint8 scatter-add histogram over the cropped (B*Hc*Wc, Sc)
   column bins plus a reverse lane cumsum turns the key multiset into
   per-center crossing parities, which are pasted into the full
   (B, S, H, W) canvas at each mesh's crop origin.

Round-5 batching (VERDICT r4 #1): the round-4 design ran one program
per mesh over a FULL-CANVAS histogram. This version pools every mesh
of a batch into ONE window-key program per size class plus ONE
parity+paste program, and crops the histogram to the batch's padded
mesh bbox (organ/canvas ratio ~4-5x less HBM traffic at bench scale).
The upload format is per-vertex f32 + uint16 faces + 8 B/triangle
sideband (~1.8 MB for a 50k-pt organ mesh vs 4.7 MB for the round-4
per-triangle layout) — through a transfer-priced link the payload IS
the cost, so the format is part of the kernel design.

Exactness notes (the device path is bit-equal to the host f64 twin,
pinned in tests/test_mesh_utils.py):

- anchors (iu0, iv0) and window extents (nu, nv) are computed on the
  host in f64, exactly as the host twin enumerates candidates;
- vertex coordinates are eps-shifted in f64 then cast to f32 ONCE per
  vertex; the device subtracts the integer anchor from the f32 value,
  which is EXACT (Sterbenz: |u - au| <= 34 with u within 2 of au, and
  the exact difference is representable on f32's finer grid at the
  smaller magnitude), so local window coordinates carry only the one
  f64->f32 cast rounding — inside the 1e-4 generic-position margins;
- the slice crop [0, k_hi] uses k_hi = floor(max w) + 1, which bounds
  every f32 OR f64 barycentric interpolation of w (each is <= max w
  up to rounding), so no key can escape the cropped bins; the low end
  is NOT cropped because an open (non-watertight or class-split) face
  soup legitimately carries parity all the way down to k = 0.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

__all__ = ["voxelize_mesh_device", "voxelize_batch"]

_RAY_EPS_U = 1.0e-4
_RAY_EPS_V = 2.3e-4
_WINDOW_CLASSES = (2, 4, 8, 16, 32)
# sub-batch bound: keeps the cropped counts buffer + the (B, S, H, W)
# output block bounded, and the int32 key space guard simple
_MAX_CHUNK = 8


@partial(jax.jit, static_argnames=("P", "Hc", "Wc", "Sc", "S"))
def _window_keys_batch(vu, vv, vw, faces, side, voff, cu0, cv0,
                       P, Hc, Wc, Sc, S):
    """Pooled per-(triangle, window-pixel) crossing keys for one size
    class across a whole mesh batch.

    vu, vv, vw: (Nv,) f32 per-vertex eps-shifted coordinates (all
    meshes concatenated); faces: (T, 3) uint16 mesh-local (or int32
    batch-global) vertex indices; side: (T, 3) uint16 sideband
    [iu0, iv0, nu | nv << 6 | mesh_id << 12] with host-f64
    anchors/extents (padding rows carry mesh_id == B, so B <= 15 per
    chunk); voff/cu0/cv0: (B + 1,) int32 per-mesh vertex offsets and
    crop origins.
    Returns (T * P * P,) int32 keys into the (B*Hc*Wc, Sc) cropped
    histogram; misses get the sentinel B*Hc*Wc*Sc.
    """
    T = faces.shape[0]
    B = voff.shape[0] - 1
    iu0 = side[:, 0].astype(jnp.int32)
    iv0 = side[:, 1].astype(jnp.int32)
    packed = side[:, 2].astype(jnp.int32)
    nu = packed & 0x3F
    nv = (packed >> 6) & 0x3F
    mid = packed >> 12
    valid = mid < B
    midc = jnp.minimum(mid, B - 1)

    f = faces.astype(jnp.int32)
    if faces.dtype == jnp.uint16:
        f = f + voff[midc][:, None]
    u = vu[f]                                   # (T, 3)
    v = vv[f]
    w = vw[f]
    # EXACT integer-anchor subtraction (see module docstring)
    u = u - iu0.astype(jnp.float32)[:, None]
    v = v - iv0.astype(jnp.float32)[:, None]

    du = jnp.arange(P, dtype=jnp.float32)
    dv = jnp.arange(P, dtype=jnp.float32)
    pu = du[None, None, :]                      # (1, 1, P)
    pv = dv[None, :, None]                      # (1, P, 1)

    u0 = u[:, 0][:, None, None]
    u1 = u[:, 1][:, None, None]
    u2 = u[:, 2][:, None, None]
    v0 = v[:, 0][:, None, None]
    v1 = v[:, 1][:, None, None]
    v2 = v[:, 2][:, None, None]
    den = (v1 - v2) * (u0 - u2) + (u2 - u1) * (v0 - v2)
    safe = jnp.abs(den) > 1e-12
    den = jnp.where(safe, den, 1.0)
    a = ((v1 - v2) * (pu - u2) + (u2 - u1) * (pv - v2)) / den
    b = ((v2 - v0) * (pu - u2) + (u0 - u2) * (pv - v2)) / den
    c = 1.0 - a - b
    hit = safe & (a >= 0.0) & (b >= 0.0) & (c >= 0.0)

    # anchored at w0 so a FLAT face (w0 == w1 == w2) interpolates to
    # exactly w0 at any height — `a*w0 + b*w1 + c*w2` rounds each
    # product, so caps at e.g. z = 7.0 came out 7 +- 4e-7 (review
    # finding: 632, then 27, differing voxels on a box vs the host)
    w0 = w[:, 0][:, None, None]
    wc = (w0 + b * (w[:, 1][:, None, None] - w0)
          + c * (w[:, 2][:, None, None] - w0))
    # host twin: k_max = floor(wc - 1e-9) in f64, i.e. an EXACT
    # integer crossing height k flips centers < k. The 1e-9 nudge
    # underflows in f32 (ulp at wc >= 2 is 2.4e-7), so express the
    # same semantics directly: floor, minus one exactly at integers.
    # Residual boundary: a SLANTED face whose crossing lands within
    # f32 rounding of an integer height can still round differently
    # than the host's f64 — there the voxel center lies ON the
    # surface, where in/out is genuinely ambiguous (documented in
    # voxelize_mesh_device's docstring).
    kf = jnp.floor(wc)
    k_max = (kf - (wc == kf).astype(jnp.float32)).astype(jnp.int32)
    ok = (hit
          & (du[None, None, :] < nu[:, None, None].astype(jnp.float32))
          & (dv[None, :, None] < nv[:, None, None].astype(jnp.float32))
          & (k_max >= 0)
          & valid[:, None, None])
    k_cl = jnp.minimum(k_max, S - 1)
    # cropped, batch-folded column index: rows are mesh_id*Hc + local
    au_loc = iu0 - cu0[midc]
    row_g = midc * Hc + iv0 - cv0[midc]
    col = ((row_g[:, None, None]
            + jnp.arange(P, dtype=jnp.int32)[None, :, None]) * Wc
           + au_loc[:, None, None]
           + jnp.arange(P, dtype=jnp.int32)[None, None, :])
    key = col * Sc + k_cl
    sent = jnp.int32(B * Hc * Wc * Sc)
    return jnp.where(ok, key, sent).reshape(T * P * P)


@partial(jax.jit, static_argnames=("B", "Sc", "Hc", "Wc", "S", "H", "W"))
def _parity_paste(keys, origins, B, Sc, Hc, Wc, S, H, W):
    """keys: (N,) int32 into the (B*Hc*Wc, Sc) cropped bins (sentinel
    = B*Hc*Wc*Sc); origins: (B, 2) int32 paste origins (cv0, cu0).
    Returns the full (B, S, H, W) uint8 parity masks.

    Scatter-add histogram + reverse lane-axis cumsum, all in uint8:
    parity is mod-2 and mod-256 wraparound preserves mod-2, so the
    narrow dtype is EXACT (bit-equality vs the int32 formulation
    verified on-chip) while the bbox crop shrinks the counts buffer by
    the organ/canvas ratio (~4.5x at bench scale). The scatter beat
    the sort+searchsorted formulation it replaced by 170x (31.7M dense
    binary-search gathers cost 5.7 s; a 1M-key scatter 17 ms)."""
    nb = B * Hc * Wc
    counts = jnp.zeros(nb * Sc + 1, jnp.uint8).at[keys].add(
        jnp.uint8(1))
    per_col = counts[: nb * Sc].reshape(nb, Sc)
    # suffix count #(k_max >= k) per column mod 256: reverse cumsum
    # along the tiny lane axis (wraps, parity-safe)
    suffix = jnp.cumsum(per_col[:, ::-1], axis=1,
                        dtype=jnp.uint8)[:, ::-1]
    crop = (suffix & 1).reshape(B, Hc, Wc, Sc)
    crop = jnp.moveaxis(crop, 3, 1)                  # (B, Sc, Hc, Wc)
    out = jnp.zeros((B, S, H, W), jnp.uint8)
    for bq in range(B):
        out = jax.lax.dynamic_update_slice(
            out, crop[bq][None], (bq, 0, origins[bq, 0],
                                  origins[bq, 1]))
    return out


def _prep_mesh(pts, faces, plane, S, H, W):
    """Host f64 prep for one mesh: eps-shifted per-vertex f32 coords,
    per-class live-face index lists + uint16 sideband, the padded crop
    box, and the rare big-face host-parity term."""
    pts = np.asarray(pts, np.float64)
    faces = np.asarray(faces, np.int64).reshape(-1, 3)
    x, y, z = pts[:, 0], pts[:, 1], pts[:, 2]
    if plane == "Axial":
        pw, pv, pu = z, y, x
    elif plane == "Coronal":
        pw, pv, pu = y, z, x
    else:
        pw, pv, pu = x, z, y
    u64 = pu - _RAY_EPS_U
    v64 = pv - _RAY_EPS_V
    vu = u64.astype(np.float32)
    vv = v64.astype(np.float32)
    vw = pw.astype(np.float32)

    tri_u = u64[faces]
    tri_v = v64[faces]
    iu0 = np.clip(np.ceil(tri_u.min(axis=1)).astype(np.int64), 0, W - 1)
    iu1 = np.clip(np.floor(tri_u.max(axis=1)).astype(np.int64), -1,
                  W - 1)
    iv0 = np.clip(np.ceil(tri_v.min(axis=1)).astype(np.int64), 0, H - 1)
    iv1 = np.clip(np.floor(tri_v.max(axis=1)).astype(np.int64), -1,
                  H - 1)
    nu = np.maximum(iu1 - iu0 + 1, 0)
    nv = np.maximum(iv1 - iv0 + 1, 0)
    live = (nu > 0) & (nv > 0)
    span = np.maximum(nu, nv)

    classes = {}
    prev = 0
    for P in _WINDOW_CLASSES:
        sel = np.nonzero(live & (span > prev) & (span <= P))[0]
        prev = P
        if sel.size:
            classes[P] = sel
    big = np.nonzero(live & (span > _WINDOW_CLASSES[-1]))[0]
    host_term = None
    if big.size:
        # rare huge faces (synthetic boxes): host hit-list, exact
        from ..utils.convert import voxelize as host_vox
        sub = np.stack([pw[faces[big]], tri_v[big] + _RAY_EPS_V,
                        tri_u[big] + _RAY_EPS_U], axis=-1)
        host_term = host_vox._parity_fill(sub, S, H, W)

    if classes:
        allc = np.concatenate(list(classes.values()))
        cu0 = int(iu0[allc].min())
        cu1 = int(iu1[allc].max())
        cv0 = int(iv0[allc].min())
        cv1 = int(iv1[allc].max())
        wlive = pw[faces[allc]]
        k_hi = int(min(S - 1, np.floor(wlive.max()) + 1))
        crop = (cu0, cu1, cv0, cv1, k_hi)
    else:
        crop = None
    return {"vu": vu, "vv": vv, "vw": vw, "faces": faces,
            "iu0": iu0, "iv0": iv0, "nu": nu, "nv": nv,
            "classes": classes, "crop": crop, "host_term": host_term}


def _pad_to(n, m):
    return -(-n // m) * m


def _chunk_dims(crops, S, H, W):
    """Shared padded crop-block dims for a chunk's non-empty crops."""
    Wc = min(W, _pad_to(max(c[1] - c[0] + 1 for c in crops), 32))
    Hc = min(H, _pad_to(max(c[3] - c[2] + 1 for c in crops), 32))
    Sc = min(S, _pad_to(max(c[4] for c in crops) + 1, 8))
    return Hc, Wc, Sc


def _greedy_chunks(preps, S, H, W):
    """Split preps into sub-batches that respect _MAX_CHUNK, the
    15-mesh sideband id field, and the int32 key space."""
    spans = []
    i = 0
    while i < len(preps):
        n = min(_MAX_CHUNK, len(preps) - i)
        while n > 1:
            crops = [p["crop"] for p in preps[i:i + n]
                     if p["crop"] is not None]
            if not crops:
                break
            Hc, Wc, Sc = _chunk_dims(crops, S, H, W)
            if n * Hc * Wc * Sc + 1 < 2**31:
                break
            n -= 1
        spans.append((i, i + n))
        i += n
    return spans


def _assemble_chunk(preps, S, H, W, stats=None):
    """Stage <= _MAX_CHUNK prepped meshes onto the device: shared crop
    box, concatenated vertex arrays, per-class padded face + sideband
    buffers. Returns None when no mesh has classed triangles."""
    B = len(preps)
    crops = [p["crop"] for p in preps if p["crop"] is not None]
    if not crops:
        return None
    Hc, Wc, Sc = _chunk_dims(crops, S, H, W)
    if B * Hc * Wc * Sc + 1 >= 2**31:
        raise ValueError("voxelize chunk exceeds int32 key space")
    # paste origins, shifted so the shared crop block stays
    # in-canvas (anchors are re-expressed relative to the shift)
    origins = np.zeros((B, 2), np.int32)
    voff = np.zeros(B + 1, np.int32)
    cu0s = np.zeros(B + 1, np.int32)
    cv0s = np.zeros(B + 1, np.int32)
    nver = 0
    for b, p in enumerate(preps):
        if p["crop"] is not None:
            cu0, _, cv0, _, _ = p["crop"]
            cu0 = min(cu0, W - Wc)
            cv0 = min(cv0, H - Hc)
            origins[b] = (cv0, cu0)
            cu0s[b], cv0s[b] = cu0, cv0
        voff[b] = nver
        nver += p["vu"].shape[0]
    voff[B] = nver

    dvu = jnp.asarray(np.concatenate([p["vu"] for p in preps]))
    dvv = jnp.asarray(np.concatenate([p["vv"] for p in preps]))
    dvw = jnp.asarray(np.concatenate([p["vw"] for p in preps]))
    max_vb = max(int(p["vu"].shape[0]) for p in preps)
    fdt = np.uint16 if max_vb <= 65535 else np.int32

    classes = []
    for P in _WINDOW_CLASSES:
        fl, sl = [], []
        for b, p in enumerate(preps):
            sel = p["classes"].get(P)
            if sel is None:
                continue
            fc = p["faces"][sel]
            if fdt is np.uint16:
                fl.append(fc.astype(np.uint16))
            else:
                fl.append((fc + voff[b]).astype(np.int32))
            sb = np.empty((sel.size, 3), np.uint16)
            sb[:, 0] = p["iu0"][sel]
            sb[:, 1] = p["iv0"][sel]
            sb[:, 2] = p["nu"][sel] | (p["nv"][sel] << 6) | (b << 12)
            sl.append(sb)
        if not fl:
            continue
        fc = np.concatenate(fl)
        sb = np.concatenate(sl)
        Tb = _pad_to(fc.shape[0], 256)
        fc = np.pad(fc, ((0, Tb - fc.shape[0]), (0, 0)))
        sbp = np.zeros((Tb, 3), np.uint16)
        sbp[: sb.shape[0]] = sb
        sbp[sb.shape[0]:, 2] = B << 12        # padding rows: dead id
        if stats is not None:
            stats["upload_bytes"] = (stats.get("upload_bytes", 0)
                                     + fc.nbytes + sbp.nbytes)
            stats["n_programs"] = stats.get("n_programs", 0) + 1
        classes.append((int(P), jnp.asarray(fc), jnp.asarray(sbp)))
    if stats is not None:
        stats["upload_bytes"] = (stats.get("upload_bytes", 0)
                                 + dvu.nbytes * 3 + origins.nbytes)
        stats["n_programs"] = stats.get("n_programs", 0) + 1
    return {"B": B, "Hc": Hc, "Wc": Wc, "Sc": Sc,
            "vu": dvu, "vv": dvv, "vw": dvw,
            "voff": jnp.asarray(voff), "cu0": jnp.asarray(cu0s),
            "cv0": jnp.asarray(cv0s), "origins": jnp.asarray(origins),
            "classes": classes}


def _voxelize_chunk(preps, S, H, W, stats=None):
    """One pooled device pass over <= _MAX_CHUNK prepped meshes.
    Returns the device-resident (B, S, H, W) uint8 masks."""
    B = len(preps)
    a = _assemble_chunk(preps, S, H, W, stats=stats)
    if a is None:
        out = jnp.zeros((B, S, H, W), jnp.uint8)
    else:
        key_parts = [_window_keys_batch(
            a["vu"], a["vv"], a["vw"], fc, sbp, a["voff"], a["cu0"],
            a["cv0"], P, a["Hc"], a["Wc"], a["Sc"], int(S))
            for P, fc, sbp in a["classes"]]
        keys = (key_parts[0] if len(key_parts) == 1
                else jnp.concatenate(key_parts))
        out = _parity_paste(keys, a["origins"], B, a["Sc"], a["Hc"],
                            a["Wc"], int(S), int(H), int(W))
    for b, p in enumerate(preps):
        if p["host_term"] is not None:
            ht = jnp.asarray(p["host_term"])
            out = out.at[b].set(out[b] ^ ht)
            if stats is not None:
                stats["upload_bytes"] = (stats.get("upload_bytes", 0)
                                         + p["host_term"].nbytes)
    return out


def voxelize_batch(meshes_pixel, dimensions, plane="Axial",
                   as_numpy=True, stats=None):
    """Cohort ray-parity voxelization: B meshes onto one SHARED grid —
    the batch twin of :func:`voxelize_mesh_device`, like
    rasterize_batch for contours. ONE pooled window-key program per
    size class plus ONE parity+paste program per sub-batch of
    {0} meshes (round-5 redesign; the round-4 per-mesh-program loop
    paid ~3 dispatches and a full-canvas histogram per mesh).

    meshes_pixel: list of (points_pixel (N,3), faces (T,3)) pairs;
    dimensions: shared (Z, Y, X). Returns (B, Z, Y, X) uint8 numpy,
    or the device-resident array when ``as_numpy=False`` (any plane).
    ``stats``: optional dict, filled with upload_bytes/n_programs for
    transfer-bound accounting (bench.py).
    """
    d0, d1, d2 = (int(d) for d in dimensions[:3])
    if plane == "Axial":
        S, H, W = d0, d1, d2
    elif plane == "Coronal":
        S, H, W = d1, d0, d2
    else:
        S, H, W = d2, d0, d1
    chunks = []
    preps = [_prep_mesh(p, f, plane, S, H, W) for p, f in meshes_pixel]
    for i, j in _greedy_chunks(preps, S, H, W):
        chunks.append(_voxelize_chunk(preps[i:j], S, H, W,
                                      stats=stats))
    out = (chunks[0] if len(chunks) == 1
           else jnp.concatenate(chunks) if chunks
           else jnp.zeros((0, S, H, W), jnp.uint8))
    if plane == "Coronal":
        out = jnp.moveaxis(out, 1, 2)
    elif plane == "Sagittal":
        out = jnp.moveaxis(out, 1, 3)
    return out if not as_numpy else np.asarray(out)


voxelize_batch.__doc__ = voxelize_batch.__doc__.format(_MAX_CHUNK)


def voxelize_compute_marginal_ms(meshes_pixel, dimensions,
                                 plane="Axial", iters=3):
    """Resident-input compute marginal of one pooled voxelize pass
    (window keys for every class + parity scatter + paste), in ms per
    batch pass. Measures the DEVICE cost with all inputs already
    uploaded (staging excluded). Repo timing rules:
    n vs n+iters passes chained inside ONE program via lax.scan, a
    scalar w-scale perturbation per pass blocks CSE traffic-free, and
    a full-output reduction blocks DCE."""
    import time

    d0, d1, d2 = (int(d) for d in dimensions[:3])
    if plane == "Axial":
        S, H, W = d0, d1, d2
    elif plane == "Coronal":
        S, H, W = d1, d0, d2
    else:
        S, H, W = d2, d0, d1
    preps = [_prep_mesh(p, f, plane, S, H, W)
             for p, f in meshes_pixel[:_MAX_CHUNK]]
    a = _assemble_chunk(preps, S, H, W)
    if a is None:
        return 0.0
    Ps = tuple(P for P, _, _ in a["classes"])
    B, Hc, Wc, Sc = a["B"], a["Hc"], a["Wc"], a["Sc"]

    @jax.jit
    def chain(vu, vv, vw, voff, cu0, cv0, origins, fcs, sbs, scales):
        def body(acc, s):
            parts = [_window_keys_batch(vu, vv, vw * s, fc, sb, voff,
                                        cu0, cv0, P, Hc, Wc, Sc, S)
                     for P, fc, sb in zip(Ps, fcs, sbs)]
            keys = (parts[0] if len(parts) == 1
                    else jnp.concatenate(parts))
            out = _parity_paste(keys, origins, B, Sc, Hc, Wc, S, H, W)
            return acc + out.astype(jnp.uint32).sum(), None
        r, _ = jax.lax.scan(body, jnp.uint32(0), scales)
        return r

    fcs = tuple(fc for _, fc, _ in a["classes"])
    sbs = tuple(sb for _, _, sb in a["classes"])
    args = (a["vu"], a["vv"], a["vw"], a["voff"], a["cu0"], a["cv0"],
            a["origins"], fcs, sbs)

    def run(n):
        scales = 1.0 + jnp.arange(1, n + 1, dtype=jnp.float32) * 1e-6
        return float(chain(*args, scales))

    run(1)
    run(1 + iters)                              # compile both shapes
    t1 = min(_timed(run, 1), _timed(run, 1))
    t2 = min(_timed(run, 1 + iters), _timed(run, 1 + iters))
    return max(t2 - t1, 0.0) / iters * 1000.0


def _timed(fn, *args):
    import time
    t0 = time.perf_counter()
    fn(*args)
    return time.perf_counter() - t0


def voxelize_mesh_device(points_pixel, faces, dimensions, plane="Axial",
                         as_numpy=True):
    """Device ray-parity voxelization; same contract as
    ``utils.convert.voxelize.voxelize_mesh`` (pixel-coordinate points,
    (Z, Y, X) dimensions, slicing ``plane``). ``as_numpy=False``
    returns the device-resident (Z, Y, X) uint8 array.

    Exactness vs the host f64 twin: bit-equal except where a SLANTED
    face's crossing height lands within f32 rounding of an exact
    integer — there the voxel center lies ON the surface and in/out is
    genuinely ambiguous (flat caps at integer heights agree exactly;
    see the anchored-wc note in :func:`_window_keys_batch`)."""
    faces = np.asarray(faces, np.int64).reshape(-1, 3)
    if faces.shape[0] == 0:
        d0, d1, d2 = (int(d) for d in dimensions[:3])
        z = np.zeros((d0, d1, d2), np.uint8)
        return z if as_numpy else jnp.asarray(z)
    out = voxelize_batch([(points_pixel, faces)], dimensions,
                         plane=plane, as_numpy=False)[0]
    return np.asarray(out) if as_numpy else out
