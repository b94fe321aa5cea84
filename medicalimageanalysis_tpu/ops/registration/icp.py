"""Device ICP: rigid point-set registration.

Device replacement for VTK vtkIterativeClosestPointTransform and
Open3D registration_icp (reference utils/rigid/icp.py:28-176):

- correspondences: brute-force nearest neighbor as chunked matmuls
  (|s|^2 - 2 s.t^T + |t|^2) with a running argmin scan — no KD-tree,
  the systolic array eats the quadratic term;
- alignment: Kabsch/Umeyama SVD solve;
- iteration: lax.while_loop with VTK's RMS mean-distance convergence
  test and landmark cap (default target/10, reference icp.py:79-80);
- centroid pre-matching like SetStartByMatchingCentroids.

Whole loop jit-compiles once per (L, T) bucket.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["icp_rigid", "icp_rigid_batch", "icp_point_to_plane",
           "icp_point_to_plane_batch",
           "kabsch", "nearest_neighbors"]

_CHUNK = 2048


def _bucket(n, minimum=256):
    b = minimum
    while b < n:
        b *= 2
    return b


def _nn_scan(pts, tgt, tgt_valid):
    """Shared chunked matmul nearest-neighbor scan: for each pts row, the
    index/distance of its nearest valid tgt row. ONE implementation for
    every ICP loop (round-1 review flagged the triplication)."""
    L = pts.shape[0]
    T = tgt.shape[0]
    n_chunks = T // _CHUNK
    s2 = jnp.sum(pts * pts, axis=1)

    def body(carry, chunk_idx):
        best_d2, best_idx = carry
        start = chunk_idx * _CHUNK
        tc = lax.dynamic_slice(tgt, (start, 0), (_CHUNK, 3))
        vc = lax.dynamic_slice(tgt_valid, (start,), (_CHUNK,))
        t2 = jnp.sum(tc * tc, axis=1)
        d2 = s2[:, None] - 2.0 * jnp.dot(
            pts, tc.T, preferred_element_type=jnp.float32) + t2[None, :]
        d2 = jnp.where(vc[None, :], d2, jnp.inf)
        cmin = jnp.min(d2, axis=1)
        cidx = jnp.argmin(d2, axis=1) + start
        better = cmin < best_d2
        return ((jnp.where(better, cmin, best_d2),
                 jnp.where(better, cidx, best_idx)), None)

    init = (jnp.full((L,), jnp.inf, jnp.float32),
            jnp.zeros((L,), jnp.int32))
    (best_d2, best_idx), _ = lax.scan(body, init, jnp.arange(n_chunks))
    return best_idx, best_d2


@partial(jax.jit, static_argnames=())
def _nn_chunked(src, tgt, tgt_valid):
    """src (L,3), tgt (T,3) padded, tgt_valid (T,). Returns (idx, d2)."""
    return _nn_scan(src, tgt, tgt_valid)


def nearest_neighbors(source, target):
    """Host wrapper: indices into target of each source point's NN."""
    src = np.asarray(source, dtype=np.float32)
    tgt = np.asarray(target, dtype=np.float32)
    T = tgt.shape[0]
    Tb = ((T + _CHUNK - 1) // _CHUNK) * _CHUNK
    tgt_pad = np.zeros((Tb, 3), np.float32)
    tgt_pad[:T] = tgt
    valid = np.zeros(Tb, bool)
    valid[:T] = True
    idx, d2 = _nn_chunked(jnp.asarray(src), jnp.asarray(tgt_pad),
                          jnp.asarray(valid))
    return np.asarray(idx), np.asarray(d2)


def kabsch(src, tgt, weights=None):
    """Least-squares rigid transform src -> tgt (rotation + translation)."""
    src = jnp.asarray(src, dtype=jnp.float32)
    tgt = jnp.asarray(tgt, dtype=jnp.float32)
    if weights is None:
        w = jnp.ones(src.shape[0], jnp.float32)
    else:
        w = jnp.asarray(weights, dtype=jnp.float32)
    wsum = jnp.sum(w)
    cs = jnp.sum(src * w[:, None], axis=0) / wsum
    ct = jnp.sum(tgt * w[:, None], axis=0) / wsum
    H = jnp.einsum("ni,nj->ij", (src - cs) * w[:, None], tgt - ct,
                   preferred_element_type=jnp.float32)
    U, _, Vt = jnp.linalg.svd(H)
    d = jnp.sign(jnp.linalg.det(Vt.T @ U.T))
    D = jnp.diag(jnp.array([1.0, 1.0, 1.0]) * jnp.array([1.0, 1.0, d]))
    R = (Vt.T @ D @ U.T).astype(jnp.float32)
    t = ct - R @ cs
    m = jnp.eye(4, dtype=jnp.float32)
    m = m.at[:3, :3].set(R)
    m = m.at[:3, 3].set(t)
    return m


@partial(jax.jit, static_argnames=("max_iterations",))
def _icp_loop(src, src_valid, tgt, tgt_valid, init_matrix, tol,
              max_iterations):
    """Returns (matrix4, final RMS mean distance, iterations run).
    Convergence follows VTK's SetMeanDistanceModeToRMS + CheckMeanDistance:
    stop when the RMS mean distance changes by less than `tol`."""

    def _icp_nn(pts):
        return _nn_scan(pts, tgt, tgt_valid)

    def apply(m, pts):
        return pts @ m[:3, :3].T + m[:3, 3]

    def cond(state):
        _, prev_md, cur_md, it = state
        return (it < max_iterations) & (jnp.abs(prev_md - cur_md) > tol)

    def step(state):
        m, _, cur_md, it = state
        pts = apply(m, src)
        idx, _ = _icp_nn(pts)
        corr = tgt[idx]
        w = src_valid.astype(jnp.float32)
        delta = kabsch(pts, corr, weights=w)
        new_m = delta @ m
        new_pts = apply(new_m, src)
        _, d2 = _icp_nn(new_pts)
        new_md = jnp.sqrt(jnp.sum(jnp.where(src_valid, d2, 0.0))
                          / jnp.sum(src_valid))
        return (new_m, cur_md, new_md, it + 1)

    pts0 = apply(init_matrix, src)
    _, d2 = _icp_nn(pts0)
    md0 = jnp.sqrt(jnp.sum(jnp.where(src_valid, d2, 0.0))
                   / jnp.sum(src_valid))
    state = (init_matrix, md0 + 2 * tol + 1.0, md0, jnp.int32(0))
    m, _, md, it = lax.while_loop(cond, step, state)
    return m, md, it


@partial(jax.jit, static_argnames=("max_iterations",))
def _icp_p2l_loop(src, src_valid, tgt, tgt_valid, tgt_normals,
                  init_matrix, tol, max_iterations):
    """Point-to-plane ICP: per iteration, linearized least squares
    min sum(((R s + t - d) . n)^2) solved as a 6x6 normal system
    (small-angle rotation [a, b, c] + translation)."""

    def _nn(pts):
        return _nn_scan(pts, tgt, tgt_valid)

    def apply(m, pts):
        return pts @ m[:3, :3].T + m[:3, 3]

    def small_angle_matrix(x):
        a, b, c, tx, ty, tz = x[0], x[1], x[2], x[3], x[4], x[5]
        R = jnp.array([[1.0, -c, b], [c, 1.0, -a], [-b, a, 1.0]])
        # re-orthonormalize via SVD to keep a proper rotation
        U, _, Vt = jnp.linalg.svd(R)
        Rn = U @ Vt
        m = jnp.eye(4)
        m = m.at[:3, :3].set(Rn)
        m = m.at[:3, 3].set(jnp.array([tx, ty, tz]))
        return m

    def step(state):
        m, _, cur_md, it = state
        pts = apply(m, src)
        idx, _ = _nn(pts)
        d = tgt[idx]
        n = tgt_normals[idx]
        w = src_valid.astype(jnp.float32)
        # rows: [cross(p, n), n], residual: (d - p) . n
        cpn = jnp.cross(pts, n)
        A = jnp.concatenate([cpn, n], axis=1) * w[:, None]   # (L, 6)
        b = jnp.einsum("ij,ij->i", d - pts, n) * w
        AtA = A.T @ A + 1e-6 * jnp.eye(6)
        Atb = A.T @ b
        x = jnp.linalg.solve(AtA, Atb)
        new_m = small_angle_matrix(x) @ m
        new_pts = apply(new_m, src)
        _, d2 = _nn(new_pts)
        new_md = jnp.sqrt(jnp.sum(jnp.where(src_valid, d2, 0.0))
                          / jnp.sum(src_valid))
        return (new_m, cur_md, new_md, it + 1)

    def cond(state):
        _, prev_md, cur_md, it = state
        return (it < max_iterations) & (jnp.abs(prev_md - cur_md) > tol)

    pts0 = apply(init_matrix, src)
    _, d2 = _nn(pts0)
    md0 = jnp.sqrt(jnp.sum(jnp.where(src_valid, d2, 0.0))
                   / jnp.sum(src_valid))
    state = (init_matrix, md0 + 2 * tol + 1.0, md0, jnp.int32(0))
    m, _, md, it = lax.while_loop(cond, step, state)
    return m, md, it


def icp_point_to_plane(source, target, target_normals, distance=1e-7,
                       iterations=100, landmarks=None, com_matching=True,
                       init_matrix=None, seed=0):
    """Point-to-plane ICP (Open3D TransformationEstimationPointToPlane
    equivalent, reference utils/rigid/icp.py:102-149 'plane' method)."""
    src = np.asarray(source, dtype=np.float32).reshape(-1, 3)
    tgt = np.asarray(target, dtype=np.float32).reshape(-1, 3)
    nrm = np.asarray(target_normals, dtype=np.float32).reshape(-1, 3)

    if landmarks is not None and src.shape[0] > landmarks:
        rng = np.random.default_rng(seed)
        sel = np.sort(rng.choice(src.shape[0], size=landmarks,
                                 replace=False))
        src = src[sel]

    L = _bucket(src.shape[0])
    src_pad = np.zeros((L, 3), np.float32)
    src_pad[:src.shape[0]] = src
    src_valid = np.zeros(L, bool)
    src_valid[:src.shape[0]] = True

    T = ((tgt.shape[0] + _CHUNK - 1) // _CHUNK) * _CHUNK
    tgt_pad = np.zeros((T, 3), np.float32)
    tgt_pad[:tgt.shape[0]] = tgt
    nrm_pad = np.zeros((T, 3), np.float32)
    nrm_pad[:tgt.shape[0]] = nrm
    tgt_valid = np.zeros(T, bool)
    tgt_valid[:tgt.shape[0]] = True

    m0 = np.eye(4, dtype=np.float32)
    if init_matrix is not None:
        m0 = np.asarray(init_matrix, dtype=np.float32)
    elif com_matching:
        m0[:3, 3] = tgt.mean(axis=0) - src.mean(axis=0)

    m, md, it = _icp_p2l_loop(
        jnp.asarray(src_pad), jnp.asarray(src_valid),
        jnp.asarray(tgt_pad), jnp.asarray(tgt_valid),
        jnp.asarray(nrm_pad), jnp.asarray(m0), jnp.float32(distance),
        int(iterations))
    return np.asarray(m, dtype=np.float64), {
        "mean_distance": float(md), "iterations": int(it)}


def icp_rigid_batch(sources, targets, distance=1e-5, iterations=200,
                    com_matching=True):
    """Batched rigid ICP: one compiled program aligning B point-set
    pairs (vmapped while_loop; runs until every pair converges).

    sources: (B, L, 3); targets: (B, T, 3) — pre-padded to shared sizes
    (pad by repeating a real point so NN stays valid).
    Returns (B, 4, 4) matrices and per-pair RMS distances.
    """
    src = np.asarray(sources, dtype=np.float32)
    tgt = np.asarray(targets, dtype=np.float32)
    B, L0, _ = src.shape
    T0 = tgt.shape[1]
    L = _bucket(L0)
    T = ((T0 + _CHUNK - 1) // _CHUNK) * _CHUNK

    src_pad = np.zeros((B, L, 3), np.float32)
    src_pad[:, :L0] = src
    src_valid = np.zeros((B, L), bool)
    src_valid[:, :L0] = True
    tgt_pad = np.zeros((B, T, 3), np.float32)
    tgt_pad[:, :T0] = tgt
    tgt_valid = np.zeros((B, T), bool)
    tgt_valid[:, :T0] = True

    m0 = np.broadcast_to(np.eye(4, dtype=np.float32), (B, 4, 4)).copy()
    if com_matching:
        m0[:, :3, 3] = tgt.mean(axis=1) - src.mean(axis=1)

    loop = jax.vmap(
        lambda s, sv, t, tv, m: _icp_loop(s, sv, t, tv, m,
                                          jnp.float32(distance),
                                          int(iterations)))
    m, md, it = jax.jit(loop)(jnp.asarray(src_pad),
                              jnp.asarray(src_valid),
                              jnp.asarray(tgt_pad),
                              jnp.asarray(tgt_valid), jnp.asarray(m0))
    return np.asarray(m, dtype=np.float64), np.asarray(md)


def icp_point_to_plane_batch(sources, targets, target_normals,
                             distance=1e-7, iterations=100,
                             com_matching=True):
    """Batched point-to-plane ICP: one compiled program aligning B
    pairs (vmapped while_loop), the symmetric counterpart of
    :func:`icp_rigid_batch`.

    sources (B, L, 3); targets / target_normals (B, T, 3), pre-padded
    to shared sizes (pad by repeating a real point + its normal).
    Returns (B, 4, 4) matrices and per-pair RMS distances."""
    src = np.asarray(sources, dtype=np.float32)
    tgt = np.asarray(targets, dtype=np.float32)
    nrm = np.asarray(target_normals, dtype=np.float32)
    B, L0, _ = src.shape
    T0 = tgt.shape[1]
    L = _bucket(L0)
    T = ((T0 + _CHUNK - 1) // _CHUNK) * _CHUNK

    src_pad = np.zeros((B, L, 3), np.float32)
    src_pad[:, :L0] = src
    src_valid = np.zeros((B, L), bool)
    src_valid[:, :L0] = True
    tgt_pad = np.zeros((B, T, 3), np.float32)
    tgt_pad[:, :T0] = tgt
    nrm_pad = np.zeros((B, T, 3), np.float32)
    nrm_pad[:, :T0] = nrm
    tgt_valid = np.zeros((B, T), bool)
    tgt_valid[:, :T0] = True

    m0 = np.broadcast_to(np.eye(4, dtype=np.float32), (B, 4, 4)).copy()
    if com_matching:
        m0[:, :3, 3] = tgt.mean(axis=1) - src.mean(axis=1)

    loop = jax.vmap(
        lambda s, sv, t, tv, n, m: _icp_p2l_loop(
            s, sv, t, tv, n, m, jnp.float32(distance), int(iterations)))
    m, md, it = jax.jit(loop)(
        jnp.asarray(src_pad), jnp.asarray(src_valid),
        jnp.asarray(tgt_pad), jnp.asarray(tgt_valid),
        jnp.asarray(nrm_pad), jnp.asarray(m0))
    return np.asarray(m, dtype=np.float64), np.asarray(md)


def icp_rigid(source, target, distance=1e-5, iterations=1000,
              landmarks=None, com_matching=True, init_matrix=None,
              seed=0):
    """Rigid ICP aligning `source` onto `target` points.

    Mirrors the VTK variant's controls: `landmarks` caps the number of
    source points used (default len(target)/10 like reference
    icp.py:79-80), `distance` is the RMS mean-distance convergence
    threshold, `com_matching` starts from centroid alignment.

    Returns (matrix4 numpy, info dict).
    """
    src = np.asarray(source, dtype=np.float32).reshape(-1, 3)
    tgt = np.asarray(target, dtype=np.float32).reshape(-1, 3)

    if landmarks is None:
        landmarks = int(np.round(tgt.shape[0] / 10))
    landmarks = max(4, min(landmarks, src.shape[0]))
    if src.shape[0] > landmarks:
        rng = np.random.default_rng(seed)
        sel = rng.choice(src.shape[0], size=landmarks, replace=False)
        src_used = src[np.sort(sel)]
    else:
        src_used = src

    L = _bucket(src_used.shape[0])
    src_pad = np.zeros((L, 3), np.float32)
    src_pad[:src_used.shape[0]] = src_used
    src_valid = np.zeros(L, bool)
    src_valid[:src_used.shape[0]] = True

    T = ((tgt.shape[0] + _CHUNK - 1) // _CHUNK) * _CHUNK
    tgt_pad = np.zeros((T, 3), np.float32)
    tgt_pad[:tgt.shape[0]] = tgt
    tgt_valid = np.zeros(T, bool)
    tgt_valid[:tgt.shape[0]] = True

    m0 = np.eye(4, dtype=np.float32)
    if init_matrix is not None:
        m0 = np.asarray(init_matrix, dtype=np.float32)
    elif com_matching:
        m0[:3, 3] = tgt.mean(axis=0) - src_used.mean(axis=0)

    m, md, it = _icp_loop(jnp.asarray(src_pad), jnp.asarray(src_valid),
                          jnp.asarray(tgt_pad), jnp.asarray(tgt_valid),
                          jnp.asarray(m0), jnp.float32(distance),
                          int(iterations))
    return np.asarray(m, dtype=np.float64), {
        "mean_distance": float(md), "iterations": int(it),
        "landmarks": int(src_used.shape[0])}
