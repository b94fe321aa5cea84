"""Thin-plate-spline landmark interpolation (3-D biharmonic).

BEYOND-PARITY: the reference has no landmark-driven registration at
all — its deformable stack is intensity-only (B-spline / demons,
reference utils/deformable/simpleitk.py:96-256) and POIs are dead
weight (never even converted to pixels, structure/poi.py:18-28). TPS
is the standard way to turn matched anatomical landmarks into a dense
deformation (ITK LandmarkDisplacementFieldSource territory) and the
natural complement: initialise or QA an intensity registration from
expert-placed points.

Formulation: minimum-bending-energy interpolant of scattered
displacements. In 3-D the biharmonic Green's function is U(r) = r
(not the 2-D r^2 log r):

    d(q) = sum_i w_i |q - p_i|  +  A [1, q]

with the classic bordered system (K + lam*I) W + P A = V, P^T W = 0.
The solve is a tiny host float64 problem (N landmarks ~ tens);
evaluation over the reference grid is the hot part and runs as
chunked matmuls: the (chunk, N) distance matrix comes from one
q @ p^T contraction, so a 256^3 grid against 100 landmarks is pure
systolic-array work.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["tps_fit", "tps_displacement", "tps_displacement_grid"]


def tps_fit(points, displacements, regularization=0.0):
    """Solve the 3-D TPS bordered system on host in float64.

    Parameters
    ----------
    points : (N, 3) anchor positions (mm, physical frame).
    displacements : (N, 3) displacement at each anchor.
    regularization : lam >= 0 added to the kernel diagonal; 0 gives
        exact interpolation, > 0 approximates (smoother, bounded
        bending energy under landmark jitter).

    Returns (W (N, 3), A (4, 3)) with the affine part ordered
    [const, x, y, z].
    """
    P = np.asarray(points, np.float64).reshape(-1, 3)
    V = np.asarray(displacements, np.float64).reshape(-1, 3)
    if P.shape[0] != V.shape[0]:
        raise ValueError("tps_fit: points/displacements length mismatch")
    n = P.shape[0]
    if n == 0:
        raise ValueError("tps_fit: no landmarks")
    if regularization < 0:
        raise ValueError("tps_fit: negative regularization")

    K = np.linalg.norm(P[:, None, :] - P[None, :, :], axis=2)
    if regularization:
        # the 3-D kernel +r is conditionally NEGATIVE definite on the
        # P^T W = 0 subspace, so the ridge must carry the kernel's
        # sign: K - lam*I stays definite there (K + lam*I sweeps
        # eigenvalues through zero -> non-monotone garbage fits)
        K = K - float(regularization) * np.eye(n)
    Q = np.concatenate([np.ones((n, 1)), P], axis=1)  # (N, 4)
    L = np.zeros((n + 4, n + 4))
    L[:n, :n] = K
    L[:n, n:] = Q
    L[n:, :n] = Q.T
    rhs = np.concatenate([V, np.zeros((4, 3))], axis=0)
    # lstsq instead of solve: degenerate layouts (coplanar/collinear/
    # too-few landmarks) drop the unresolvable affine directions
    # instead of raising
    sol = np.linalg.lstsq(L, rhs, rcond=None)[0]
    return sol[:n].astype(np.float64), sol[n:].astype(np.float64)


def _kernel_eval(q, P, W, A, p_sq):
    """(C, 3) centered queries -> (C, 3) displacements: one
    contraction for the distance matrix + one for the combine."""
    q_sq = jnp.sum(q * q, axis=1, keepdims=True)          # (C, 1)
    cross = q @ P.T                                       # (C, N)
    d2 = jnp.maximum(q_sq + p_sq[None, :] - 2.0 * cross, 0.0)
    U = jnp.sqrt(d2)
    return U @ W + A[0][None, :] + q @ A[1:]


@partial(jax.jit, static_argnames=("chunk",))
def _eval_chunked(Qpos, P, W, A, chunk):
    """(G, 3) query positions -> (G, 3) displacements, lax.map over
    row chunks."""
    G = Qpos.shape[0]
    pad = (-G) % chunk
    Qp = jnp.pad(Qpos, ((0, pad), (0, 0)))
    p_sq = jnp.sum(P * P, axis=1)  # (N,)
    chunks = Qp.reshape(-1, chunk, 3)
    out = lax.map(lambda q: _kernel_eval(q, P, W, A, p_sq),
                  chunks).reshape(-1, 3)
    return out[:G]


@partial(jax.jit, static_argnames=("shape", "chunk"))
def _eval_grid(P, W, A, origin, spacing_xyz, matrix, shape, chunk):
    """(Z, Y, X, 3) displacement grid with query positions generated
    on device per chunk from the flat voxel index — no host
    materialization of the G x 3 coordinate array (a 256^3 grid never
    exists as host temporaries)."""
    Z, Y, X = shape
    G = Z * Y * X
    n_chunks = (G + chunk - 1) // chunk
    p_sq = jnp.sum(P * P, axis=1)

    def one(i):
        idx = i * chunk + jnp.arange(chunk)
        z = idx // (Y * X)
        rem = idx % (Y * X)
        y = rem // X
        x = rem % X
        pix = jnp.stack([x.astype(jnp.float32) * spacing_xyz[0],
                         y.astype(jnp.float32) * spacing_xyz[1],
                         z.astype(jnp.float32) * spacing_xyz[2]],
                        axis=1)
        # matrix rows = pixel-axis directions (package convention):
        # scaled pixel vectors map through a row-combination pix @ M
        q = pix @ matrix + origin[None, :]
        return _kernel_eval(q, P, W, A, p_sq)

    out = lax.map(one, jnp.arange(n_chunks)).reshape(-1, 3)
    return out[:G].reshape(Z, Y, X, 3)


def _centered(points, W, A):
    """Shift the evaluation frame to the landmark centroid: at
    clinical coordinate magnitudes (|p| up to ~1e3 mm) the float32
    contraction |q|^2 + |p|^2 - 2 q.p loses ~sqrt(eps)*|p| near d2=0,
    i.e. a fraction of a mm of kernel error exactly at the landmarks.
    Centering removes the large common offset; the affine constant
    absorbs the shift exactly: A0' = A0 + c @ A[1:]."""
    P = np.asarray(points, np.float64).reshape(-1, 3)
    c = P.mean(axis=0)
    A = np.asarray(A, np.float64)
    A0 = A[0] + c @ A[1:]
    A_shift = np.concatenate([A0[None, :], A[1:]], axis=0)
    return (P - c), A_shift, c


def tps_displacement(points, W, A, queries, chunk=16384):
    """Evaluate the fitted spline at (G, 3) query positions."""
    Pc, A_shift, c = _centered(points, W, A)
    q = np.asarray(queries, np.float64).reshape(-1, 3) - c
    return _eval_chunked(jnp.asarray(q, jnp.float32),
                         jnp.asarray(Pc, jnp.float32),
                         jnp.asarray(W, jnp.float32),
                         jnp.asarray(A_shift, jnp.float32), int(chunk))


def tps_displacement_grid(points, W, A, origin, spacing, matrix, shape,
                          chunk=16384):
    """Dense (Z, Y, X, 3) mm displacement field over a grid.

    Grid voxel (z, y, x) sits at physical position
    origin + [x sx, y sy, z sz] @ matrix (rows = pixel-axis
    directions). NOTE: the package's DVF samplers
    (sample_dvf_at_points / invert_dvf) index fields axis-aligned as
    (p - origin) / spacing — pass matrix=np.eye(3) for a field those
    samplers will consume (Deformable.compute_tps does).
    """
    Z, Y, X = (int(v) for v in shape)
    Pc, A_shift, c = _centered(points, W, A)
    disp = _eval_grid(
        jnp.asarray(Pc, jnp.float32), jnp.asarray(W, jnp.float32),
        jnp.asarray(A_shift, jnp.float32),
        jnp.asarray(np.asarray(origin, np.float64) - c, jnp.float32),
        jnp.asarray(np.asarray(spacing, np.float64), jnp.float32),
        jnp.asarray(np.asarray(matrix, np.float64), jnp.float32),
        (Z, Y, X), int(chunk))
    return np.asarray(disp, np.float32)
