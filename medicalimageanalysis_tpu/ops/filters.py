"""Volume filtering kernels: Gaussian, morphology, windowing, threshold.

Device replacements for the scipy/skimage/SimpleITK filter calls in
the reference (reference utils/image/threshold.py:17-49,
utils/deformable/simpleitk.py:58-74). Separable Gaussian runs as three
matrix contractions; morphology as ``lax.reduce_window`` min/max pools —
both batched over volumes with vmap.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["gaussian_filter", "binary_erode", "binary_dilate",
           "binary_open", "binary_close", "window_level",
           "largest_component", "largest_component_batch",
           "fill_holes_2d", "histogram_match", "anisotropic_diffusion",
           "curvature_flow"]


def gauss_taps(sigma_vox, dtype=np.float32):
    """Normalized 1-D Gaussian taps truncated at 4 sigma ->
    (taps (2r+1,), radius). The SINGLE source of the tap formula: the
    dense Toeplitz matrix below and the z-sharded halo pass
    (parallel/halo.py) both build from it, which is what makes
    sharded-vs-single-device smoothing bit-equivalent."""
    radius = max(1, int(np.ceil(4 * sigma_vox)))
    offsets = np.arange(-radius, radius + 1)
    k = np.exp(-0.5 * (offsets / sigma_vox) ** 2)
    return (k / k.sum()).astype(dtype), radius


def _gauss_kernel_matrix(n, sigma_vox, dtype=np.float32):
    """(n, n) Toeplitz Gaussian matrix: out = G @ x along one axis.
    Dense so XLA runs it as a matrix product; truncated at 4 sigma."""
    k64, radius = gauss_taps(sigma_vox, dtype=np.float64)
    offsets = np.arange(-radius, radius + 1)
    k = k64
    m = np.zeros((n, n), dtype=np.float64)
    idx = np.arange(n)
    for off, w in zip(offsets, k):
        src = np.clip(idx + off, 0, n - 1)  # edge-replicate
        np.add.at(m, (idx, src), w)
    return m.astype(dtype)


@jax.jit
def _separable3(vol, mz, my, mx):
    # HIGHEST: TF32 taps shift a smoothed HU value by whole units
    hi = lax.Precision.HIGHEST
    out = jnp.einsum("ij,jyx->iyx", mz, vol, precision=hi,
                     preferred_element_type=jnp.float32)
    out = jnp.einsum("kj,zjx->zkx", my, out, precision=hi,
                     preferred_element_type=jnp.float32)
    out = jnp.einsum("lj,zyj->zyl", mx, out, precision=hi,
                     preferred_element_type=jnp.float32)
    return out


def gaussian_filter(volume, sigma_mm, spacing_xyz=(1.0, 1.0, 1.0)):
    """Separable Gaussian blur; sigma in mm, converted per-axis to
    voxels (matches sitk SmoothingRecursiveGaussian semantics used at
    reference utils/deformable/simpleitk.py:58-74)."""
    vol = jnp.asarray(volume, dtype=jnp.float32)
    if np.isscalar(sigma_mm):
        sigma_mm = [sigma_mm] * 3
    sz = sigma_mm[2] / spacing_xyz[2]
    sy = sigma_mm[1] / spacing_xyz[1]
    sx = sigma_mm[0] / spacing_xyz[0]
    mz = jnp.asarray(_gauss_kernel_matrix(vol.shape[0], max(sz, 1e-3)))
    my = jnp.asarray(_gauss_kernel_matrix(vol.shape[1], max(sy, 1e-3)))
    mx = jnp.asarray(_gauss_kernel_matrix(vol.shape[2], max(sx, 1e-3)))
    return _separable3(vol, mz, my, mx)


@partial(jax.jit, static_argnames=("size",))
def _minpool(vol, size):
    window = (1,) * (vol.ndim - 3) + (size, size, size)
    return lax.reduce_window(vol, jnp.inf, lax.min, window,
                             (1,) * vol.ndim, "SAME")


@partial(jax.jit, static_argnames=("size",))
def _maxpool(vol, size):
    window = (1,) * (vol.ndim - 3) + (size, size, size)
    return lax.reduce_window(vol, -jnp.inf, lax.max, window,
                             (1,) * vol.ndim, "SAME")


def binary_erode(mask, size=3, iterations=1):
    """Erosion as min-pool; accepts (Z, Y, X) or batched (B, Z, Y, X)."""
    out = jnp.asarray(mask, dtype=jnp.float32)
    for _ in range(iterations):
        out = _minpool(out, size)
    return np.asarray(out > 0.5).astype(np.uint8)


def binary_dilate(mask, size=3, iterations=1):
    """Dilation as max-pool; accepts (Z, Y, X) or batched (B, Z, Y, X)."""
    out = jnp.asarray(mask, dtype=jnp.float32)
    for _ in range(iterations):
        out = _maxpool(out, size)
    return np.asarray(out > 0.5).astype(np.uint8)


def binary_open(mask, size=3):
    return binary_dilate(binary_erode(mask, size), size)


def binary_close(mask, size=3):
    return binary_erode(binary_dilate(mask, size), size)


@jax.jit
def _window_level(vol, lower, upper):
    return jnp.clip((vol - lower) / (upper - lower), 0.0, 1.0)


def window_level(volume, window):
    """Normalize to [0, 1] within [lower, upper] display window."""
    vol = jnp.asarray(volume, dtype=jnp.float32)
    return _window_level(vol, jnp.float32(window[0]), jnp.float32(window[1]))


def largest_component(binary, connectivity_full=True):
    """Largest connected component (host scipy labeling; the reference
    used skimage.measure.label whose default is full connectivity)."""
    from scipy import ndimage

    binary = np.asarray(binary) > 0
    structure = np.ones((3,) * binary.ndim) if connectivity_full else None
    labels, n = ndimage.label(binary, structure=structure)
    if n == 0:
        return np.zeros_like(binary, dtype=bool), None
    counts = np.bincount(labels.ravel())
    counts[0] = 0
    biggest = int(np.argmax(counts))
    mask = labels == biggest
    slices = ndimage.find_objects((labels == biggest).astype(np.int8))
    return mask, slices[0] if slices else None


def fill_holes_2d(mask2d):
    from scipy import ndimage
    return ndimage.binary_fill_holes(mask2d)


@jax.jit
def _label_prop_largest(mask):
    """Largest 26-connected component by iterative label propagation:
    every masked voxel starts at its own flat index and repeatedly takes
    the minimum over its 3x3x3 neighborhood (a min reduce_window) until
    a fixed point — a pure stencil loop, one XLA program (SURVEY §7's
    device CC sketch). Returns (largest-component bool mask, n_voxels)."""
    from jax import lax

    Z, Y, X = mask.shape
    n = Z * Y * X
    big = jnp.int32(n)
    idx = jnp.arange(n, dtype=jnp.int32).reshape(Z, Y, X)
    lab0 = jnp.where(mask, idx, big)

    def sweep(lab):
        m = lax.reduce_window(lab, big, lax.min, (3, 3, 3), (1, 1, 1),
                              "SAME")
        return jnp.where(mask, jnp.minimum(lab, m), big)

    def cond(state):
        _, changed = state
        return changed

    def body(state):
        lab, _ = state
        new = sweep(lab)
        return new, jnp.any(new != lab)

    lab, _ = lax.while_loop(cond, body, (sweep(lab0), jnp.bool_(True)))

    flat = jnp.where(mask.ravel(), lab.ravel(), 0)
    counts = jnp.zeros(n, jnp.int32).at[flat].add(
        mask.ravel().astype(jnp.int32))
    best = jnp.argmax(counts)
    out = (lab == best) & mask
    return out, counts[best]


def largest_component_batch(masks):
    """Device largest-connected-component over a batch of binary masks
    (B, Z, Y, X) — the cohort-scale counterpart of
    :func:`largest_component`, which stays on host scipy for single
    volumes (fast for one mask, serial for a cohort). 26-connectivity,
    matching the reference's skimage.measure.label default.

    Scaling caveat: label propagation converges in O(component
    diameter) full-volume sweeps and the per-volume count buffer is
    Z*Y*X int32, so at clinical 512^2 sizes with snaking components the
    host scipy path can win — measured 1.5x device advantage at
    8x(40,128,128); benchmark before choosing for larger cohorts."""
    m = jnp.asarray(masks) > 0
    if m.ndim == 3:
        out, _ = _label_prop_largest(m)
        return np.asarray(out)
    outs = jax.jit(jax.vmap(lambda x: _label_prop_largest(x)[0]))(m)
    return np.asarray(outs)


def histogram_match(moving, reference, n_quantiles=256,
                    exclude_below=None, max_samples=1 << 20):
    """Quantile-mapping intensity standardization — the
    SimpleITK HistogramMatchingImageFilter workflow the reference's
    users reach for before cross-scanner MR registration (NEW; no
    reference counterpart). Maps ``moving``'s intensity distribution
    onto ``reference``'s: v -> interp(ref_quantiles at the quantile
    rank of v in moving).

    The two quantile tables are estimated host-side from up to
    ``max_samples`` strided samples (estimation is statistics, not a
    hot path); the per-voxel piecewise-linear mapping runs as one
    device ``jnp.interp`` over the full volume. ``exclude_below``
    (e.g. an air threshold) drops background from BOTH tables — the
    usual ThresholdAtMeanIntensity stand-in — while still mapping
    every voxel (background maps through the table's lower edge).
    Returns float32, same shape as ``moving``.
    """
    mov_np = np.asarray(moving, np.float32)
    ref_np = np.asarray(reference, np.float32)

    def table(a):
        flat = a.reshape(-1)
        if exclude_below is not None:
            flat = flat[flat >= exclude_below]
            if flat.size == 0:
                raise ValueError(
                    "histogram_match: exclude_below removed every voxel")
        if flat.size > max_samples:
            flat = flat[:: flat.size // max_samples + 1]
        q = np.linspace(0.0, 1.0, int(n_quantiles), dtype=np.float64)
        return np.quantile(flat, q).astype(np.float32)

    mov_q = table(mov_np)
    ref_q = table(ref_np)
    # strictly increasing source table for a well-defined inverse CDF
    # (flat runs — e.g. a dominant background value — would make interp
    # return the first hit; nudging by tiny epsilons keeps it monotone).
    # The nudge must clear float32 resolution at the table's MAGNITUDE,
    # not just its range: at mov ~ 10^4 with a narrow range, a
    # range-scaled eps is below ulp(10^4) and the cast back to float32
    # re-collapses the knots (duplicate knots anchor interp at the END
    # of a run instead of the documented lower edge). Spread in float64
    # then enforce strictness knot-by-knot with nextafter.
    eps = np.maximum(1e-6, 1e-6 * float(mov_q[-1] - mov_q[0]))
    mov_q = np.maximum.accumulate(mov_q.astype(np.float64))
    mov_q = (mov_q + np.arange(len(mov_q)) * eps).astype(np.float32)
    for i in range(1, len(mov_q)):
        if mov_q[i] <= mov_q[i - 1]:
            mov_q[i] = np.nextafter(mov_q[i - 1], np.float32(np.inf),
                                    dtype=np.float32)

    out = jnp.interp(jnp.asarray(mov_np), jnp.asarray(mov_q),
                     jnp.asarray(ref_q))
    return out.astype(jnp.float32)


@partial(jax.jit, static_argnames=("iterations", "conductance_fn"))
def _aniso_core(vol, sp2_inv, kappa, time_step, iterations,
                conductance_fn):
    def flux(v, axis):
        # forward difference with edge-zero flux (Neumann boundary)
        d = jnp.diff(v, axis=axis)
        pad = [(0, 0)] * 3
        pad[axis] = (0, 1)
        return jnp.pad(d, pad)

    sp_inv = jnp.sqrt(sp2_inv)

    def body(_, v):
        upd = jnp.zeros_like(v)
        for axis, w, hi in ((0, sp2_inv[2], sp_inv[2]),
                            (1, sp2_inv[1], sp_inv[1]),
                            (2, sp2_inv[0], sp_inv[0])):
            df = flux(v, axis)                      # I(i+1) - I(i)
            # conductance gates on the PHYSICAL gradient df/h
            # (intensity/mm, like ITK) — raw per-voxel differences
            # would make kappa axis-dependent under anisotropic spacing
            grad = df * hi
            if conductance_fn == "exp":
                c = jnp.exp(-(grad / kappa) ** 2)
            else:                                   # 'reciprocal'
                c = 1.0 / (1.0 + (grad / kappa) ** 2)
            fl = c * df
            pad = [(0, 0)] * 3
            pad[axis] = (1, 0)
            fb = jnp.pad(fl, pad)[
                tuple(slice(0, s) for s in v.shape)]
            upd = upd + (fl - fb) * w
        return v + time_step * upd

    return lax.fori_loop(0, iterations, body, vol)


def anisotropic_diffusion(volume, iterations=5, kappa=20.0,
                          time_step=None, spacing_xyz=(1.0, 1.0, 1.0),
                          conductance="exp"):
    """Perona-Malik edge-preserving smoothing — the device twin of
    ITK's GradientAnisotropicDiffusionImageFilter (the MR denoising
    front-end the reference's SimpleITK stack ships but never
    exposes). Per iteration, each axis' forward-difference flux is
    gated by a conductance of the local gradient (``'exp'`` — ITK's
    default — or ``'reciprocal'``), so noise diffuses while edges
    (|dI| >> kappa) do not. The whole loop is one jit (a fori_loop of
    shifted adds — elementwise stencils).

    ``kappa``: physical gradient magnitude (intensity per mm — the
    conductance gates on df/spacing, so the edge threshold is
    axis-independent under anisotropic spacing, matching ITK) treated
    as an edge; ``time_step`` defaults to the 3-D stability bound
    1 / (2 * sum(1/sp^2)). Returns float32.
    """
    vol = jnp.asarray(volume, jnp.float32)
    if vol.ndim != 3:
        raise ValueError(f"anisotropic_diffusion: expected (Z, Y, X), "
                         f"got {vol.shape}")
    if conductance not in ("exp", "reciprocal"):
        raise ValueError(f"anisotropic_diffusion: unknown conductance "
                         f"{conductance!r}")
    sp = np.asarray(spacing_xyz, np.float64)
    sp2_inv = jnp.asarray(1.0 / sp ** 2, jnp.float32)
    if time_step is None:
        time_step = 1.0 / (2.0 * float((1.0 / sp ** 2).sum()))
    return _aniso_core(vol, sp2_inv, jnp.float32(kappa),
                       jnp.float32(time_step), int(iterations),
                       str(conductance))


@partial(jax.jit, static_argnames=("iterations",))
def _curvature_core(vol, sp_j, time_step, iterations):
    eps = 1e-8

    def g(v, axis):
        d = jnp.gradient(v, axis=axis)
        return d / sp_j[2 - axis]

    def body(_, v):
        ix = g(v, 2)
        iy = g(v, 1)
        iz = g(v, 0)
        ixx = g(ix, 2)
        iyy = g(iy, 1)
        izz = g(iz, 0)
        ixy = g(ix, 1)
        ixz = g(ix, 0)
        iyz = g(iy, 0)
        g2 = ix * ix + iy * iy + iz * iz
        num = (ixx * (iy * iy + iz * iz)
               + iyy * (ix * ix + iz * iz)
               + izz * (ix * ix + iy * iy)
               - 2.0 * (ix * iy * ixy + ix * iz * ixz + iy * iz * iyz))
        return v + time_step * num / (g2 + eps)

    return lax.fori_loop(0, iterations, body, vol)


def curvature_flow(volume, iterations=5, time_step=0.05,
                   spacing_xyz=(1.0, 1.0, 1.0)):
    """Level-set curvature flow denoising — the device twin of
    ITK's CurvatureFlowImageFilter: each iso-intensity surface moves
    with speed proportional to its mean curvature (dI/dt = kappa
    |grad I|), smoothing noise while leaving straight edges in place.
    Central-difference stencils in one jitted fori_loop. Returns
    float32."""
    vol = jnp.asarray(volume, jnp.float32)
    if vol.ndim != 3:
        raise ValueError(f"curvature_flow: expected (Z, Y, X), got "
                         f"{vol.shape}")
    sp_j = jnp.asarray(spacing_xyz, jnp.float32)
    return _curvature_core(vol, sp_j, jnp.float32(time_step),
                           int(iterations))
