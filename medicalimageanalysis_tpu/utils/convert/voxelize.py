"""Exact mesh voxelization by ray-casting parity — BEYOND-PARITY.

Fills voxel centers inside a closed triangle mesh by counting
ray-triangle crossings along the slicing axis (Jordan parity). Unlike
plane-slicing + polygon rasterization (ModelToMask's 3MF path), this
uses the faces directly, so it is immune to loop-chaining
fragmentation on non-welded surfaces (a discrete marching mesh can
shatter one plane cut into dozens of open polylines, which XOR
rasterization turns into noise). Fully vectorized: per-triangle
integer-bbox candidate rays via repeat/cumsum indexing, one
barycentric solve, one scatter-add difference fill, one cumsum-mod-2.

Rays pass through voxel centers (integer pixel coordinates) with a
small fractional shift so they never hit mesh edges/vertices exactly
(generic position); watertight input gives even per-column crossing
counts and an exact fill.
"""

from __future__ import annotations

import numpy as np

__all__ = ["voxelize_mesh"]

_RAY_EPS_U = 1.0e-4
_RAY_EPS_V = 2.3e-4


def _parity_fill(tri, S, H, W):
    """tri: (T, 3, 3) with coordinate columns (w, v, u): w = slicing
    coordinate in [0, S), v -> H index, u -> W index. Returns a
    (S, H, W) uint8 parity mask of voxel centers."""
    if tri.shape[0] == 0:
        return np.zeros((S, H, W), np.uint8)
    w = tri[:, :, 0]
    v = tri[:, :, 1] - _RAY_EPS_V
    u = tri[:, :, 2] - _RAY_EPS_U

    iu0 = np.ceil(u.min(axis=1)).astype(np.int64)
    iu1 = np.floor(u.max(axis=1)).astype(np.int64)
    iv0 = np.ceil(v.min(axis=1)).astype(np.int64)
    iv1 = np.floor(v.max(axis=1)).astype(np.int64)
    iu0 = np.clip(iu0, 0, W - 1)
    iu1 = np.clip(iu1, -1, W - 1)
    iv0 = np.clip(iv0, 0, H - 1)
    iv1 = np.clip(iv1, -1, H - 1)
    nu = np.maximum(iu1 - iu0 + 1, 0)
    nv = np.maximum(iv1 - iv0 + 1, 0)
    counts = nu * nv
    total = int(counts.sum())
    if total == 0:
        return np.zeros((S, H, W), np.uint8)

    t_idx = np.repeat(np.arange(tri.shape[0]), counts)
    offs = np.arange(total) - np.repeat(np.cumsum(counts) - counts,
                                        counts)
    nu_t = nu[t_idx]
    pu = iu0[t_idx] + offs % nu_t
    pv = iv0[t_idx] + offs // nu_t

    # 2D barycentric of the ray point in the (u, v) projection
    u0, u1, u2 = u[t_idx, 0], u[t_idx, 1], u[t_idx, 2]
    v0, v1, v2 = v[t_idx, 0], v[t_idx, 1], v[t_idx, 2]
    den = (v1 - v2) * (u0 - u2) + (u2 - u1) * (v0 - v2)
    safe = np.abs(den) > 1e-12
    den = np.where(safe, den, 1.0)
    a = ((v1 - v2) * (pu - u2) + (u2 - u1) * (pv - v2)) / den
    b = ((v2 - v0) * (pu - u2) + (u0 - u2) * (pv - v2)) / den
    c = 1.0 - a - b
    hit = safe & (a >= 0.0) & (b >= 0.0) & (c >= 0.0)
    if not hit.any():
        return np.zeros((S, H, W), np.uint8)

    wc = (a * w[t_idx, 0] + b * w[t_idx, 1] + c * w[t_idx, 2])[hit]
    pu, pv = pu[hit], pv[hit]
    # crossing above center k flips every k < wc
    k_max = np.floor(wc - 1e-9).astype(np.int64)
    keep = k_max >= 0
    k_max = np.minimum(k_max[keep], S - 1)
    pu, pv = pu[keep], pv[keep]

    # parity differences: a crossing at height wc flips every center
    # k <= k_max, so flip-counts enter at row 0 and leave at k_max+1.
    # bincount + slice-wise XOR scan: the old int32 cumsum over the
    # whole (S, H, W) volume was 96% of voxelization time (measured
    # 3.3 s cold / 0.7 s warm at organ scale vs ~15 ms for this scan).
    flat = np.bincount(k_max * (H * W) + pv * W + pu,
                       minlength=S * H * W).astype(np.uint8)
    enter = np.bincount(pv * W + pu,
                        minlength=H * W).astype(np.uint8)
    leave = flat.reshape(S, H, W)
    out = np.empty((S, H, W), np.uint8)
    acc = enter.reshape(H, W) & 1
    for k in range(S):
        out[k] = acc
        # crossings with k_max == k stop flipping ABOVE k
        acc = (acc - leave[k]) & 1
    return out


def _pick_voxelize_backend(n_faces, dims):
    """host vs device, from the measured link rate (same auto-selection
    as the marching-cubes path): the device path wins on compute
    (ops/voxelize: scatter histogram + lane cumsum) but must download
    the (Z, Y, X) uint8 mask; over a slow link the host's ragged
    hit-list is faster."""
    import jax
    if jax.default_backend() == "cpu":
        return "host"
    from ...runtime import transfer_rate_bytes_per_s
    rate = transfer_rate_bytes_per_s()
    if rate is None:
        return "host"
    # host: ~1.1 us/face (bbox+bary+scatter) + ~1 ns/voxel (XOR
    # scan); device: ~18 B/face compact upload (per-vertex f32 +
    # u16 faces + 6 B/tri sideband) + the mask download
    vox = float(np.prod(dims))
    est_host = 1.1e-6 * n_faces + 1.2e-9 * vox
    est_dev = (18.0 * n_faces + vox) / rate
    return "device" if est_dev < est_host else "host"


def voxelize_mesh(points_pixel, faces, dimensions, plane="Axial",
                  backend="auto"):
    """Voxelize a closed mesh given in PIXEL coordinates.

    points_pixel: (N, 3) (x, y, z) pixel coordinates on the target
    grid (convert physical mesh points through the image's
    position->pixel transform first); faces: (T, 3) int;
    dimensions: (Z, Y, X); plane: which pixel axis the parity rays
    follow (matches the ROI slicing-plane conventions). Returns a
    (Z, Y, X) uint8 mask of voxel centers inside the mesh.

    backend: 'auto' (default — measured-link-rate selection between
    the host hit-list and the device kernel, bit-identical results),
    'host', or 'device'.
    """
    pts = np.asarray(points_pixel, np.float64)
    if backend == "auto":
        backend = _pick_voxelize_backend(
            np.asarray(faces).reshape(-1, 3).shape[0], dimensions[:3])
    if backend == "device":
        from ...ops.voxelize import voxelize_mesh_device
        return voxelize_mesh_device(pts, faces, dimensions, plane=plane)
    faces = np.asarray(faces, np.int64).reshape(-1, 3)
    d0, d1, d2 = (int(d) for d in dimensions[:3])
    tri = pts[faces]  # (T, 3, 3) columns (x, y, z)

    x, y, z = tri[..., 0], tri[..., 1], tri[..., 2]
    if plane == "Axial":  # rays along z: (w, v, u) = (z, y, x)
        packed = np.stack([z, y, x], axis=-1)
        out = _parity_fill(packed, d0, d1, d2)
    elif plane == "Coronal":  # rays along y: (y, z, x)
        packed = np.stack([y, z, x], axis=-1)
        out = np.moveaxis(_parity_fill(packed, d1, d0, d2), 0, 1)
    else:  # Sagittal, rays along x: (x, z, y)
        packed = np.stack([x, z, y], axis=-1)
        out = np.moveaxis(_parity_fill(packed, d2, d0, d1), 0, 2)
    return out
