"""Intensity-based rigid / similarity / affine registration
(differentiable, on device).

No reference counterpart (the reference only has mesh ICP); this is the
framework's fast path for the BASELINE "rigid registration CT<->CT pair
< 100 ms" target: the resample is the trilinear gather kernel, the MSE
loss differentiates straight through it, and the whole multi-resolution
descent is one jit per pyramid level.

Pose parameterization (``mode`` selects the family, see
:func:`pose_to_matrix`): 3 Euler angles (radians) + 3 translations
(mm) about the reference volume center, optionally + log-scale(s) and
shears. The result converts to the same 4x4 ``reference -> moving``
physical matrix the Rigid object stores (reference
structure/rigid.py:438-477 semantics).
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
import optax

from ..ops import geometry as geo

__all__ = ["register_rigid_intensity", "register_rigid_intensity_batch",
           "pose_to_matrix"]


def _mm(a, b):
    """float32 geometry product at full precision: under the GPU's
    default TF32 a coordinate of ~256 mm picks up errors of ~0.1 mm."""
    return jnp.matmul(a, b, precision=jax.lax.Precision.HIGHEST)


def _rot_mats(angles):
    ax, ay, az = angles[0], angles[1], angles[2]
    cx, sx = jnp.cos(ax), jnp.sin(ax)
    cy, sy = jnp.cos(ay), jnp.sin(ay)
    cz, sz = jnp.cos(az), jnp.sin(az)
    rx = jnp.array([[1, 0, 0], [0, cx, -sx], [0, sx, cx]])
    ry = jnp.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    rz = jnp.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return _mm(_mm(rz, ry), rx)


def pose_to_matrix(pose, center):
    """Pose -> 4x4 physical transform about `center`; the parameter
    count selects the model (static under jit — shape dispatch):

    - (6,)  rigid:      angles(3) + translation(3)        M = R
    - (7,)  similarity: + log isotropic scale             M = e^s R
    - (12,) affine:     + log per-axis scales(3) + shears(3)
                        M = R @ diag(e^s) @ unit-upper-Shear

    The log-scale / R-scale-shear factorization keeps every parameter
    unconstrained (no positivity clamps) and the identity at pose 0,
    so the same Adam descent drives all three models.
    """
    pose = jnp.asarray(pose)
    n = pose.shape[0]
    R = _rot_mats(pose[:3])
    t = pose[3:6]
    if n == 6:
        M = R
    elif n == 7:
        M = jnp.exp(pose[6]) * R
    elif n == 12:
        S = jnp.diag(jnp.exp(pose[6:9]))
        H = jnp.array([[1.0, 0.0, 0.0], [0.0, 1.0, 0.0],
                       [0.0, 0.0, 1.0]])
        H = H.at[0, 1].set(pose[9]).at[0, 2].set(pose[10]) \
             .at[1, 2].set(pose[11])
        M = _mm(_mm(R, S), H)
    else:
        raise ValueError(f"pose length must be 6/7/12, got {n}")
    c = jnp.asarray(center)
    m = jnp.eye(4)
    m = m.at[:3, :3].set(M)
    m = m.at[:3, 3].set(c + t - _mm(M, c))
    return m


def _sample_grid(shape_zyx, step):
    zz = jnp.arange(0, shape_zyx[0], step[0], dtype=jnp.float32)
    yy = jnp.arange(0, shape_zyx[1], step[1], dtype=jnp.float32)
    xx = jnp.arange(0, shape_zyx[2], step[2], dtype=jnp.float32)
    Z, Y, X = jnp.meshgrid(zz, yy, xx, indexing="ij")
    return jnp.stack([X.ravel(), Y.ravel(), Z.ravel()], axis=-1)  # (N,3) xyz


# Adam's per-parameter step equals lr in parameter units, so angles
# (radians), translations (mm) and log-scales/shears need different
# effective step sizes. Optimize scaled parameters:
# pose = params * _pose_scale(n).
_POSE_SCALE = np.array([0.05, 0.05, 0.05, 5.0, 5.0, 5.0], np.float32)


def _pose_scale(n):
    """Per-parameter step scale for the 6/7/12-parameter models."""
    extra = {6: [], 7: [0.02], 12: [0.02] * 6}[int(n)]
    return np.concatenate([_POSE_SCALE,
                           np.asarray(extra, np.float32)])

_MI_BINS = 32


def _soft_bin_weights(vals, bins):
    """(N, bins) triangular soft-assignment weights for vals in [0, 1]
    (Parzen window, piecewise-linear -> differentiable). Each value hits
    <= 2 bins; the dense matrix trades memory for one matmul."""
    centers = jnp.arange(bins, dtype=jnp.float32)
    u = jnp.clip(vals, 0.0, 1.0) * (bins - 1)
    return jnp.maximum(0.0, 1.0 - jnp.abs(u[:, None] - centers[None, :]))


def _metric_loss(metric, vals, ref_vals, inside, bins=None):
    """Similarity loss over flattened sampled values.

    'mse'  — masked mean squared error (mono-modality default);
    'ncc'  — 1 - (global normalized cross-correlation)^2;
    'mi'   — negative mutual information from a soft-binned joint
             histogram: W_ref^T @ W_mov is one (bins, N) x (N, bins)
             matmul, exact-gradient through the Parzen weights.
             Values must be pre-normalized to [0, 1] (the register_*
             entry points' `normalize=True` does this). Cross-modality
             (CT<->MR) metric, BASELINE config #4."""
    v = vals.ravel()
    r = ref_vals.ravel()
    w = inside.ravel()
    n = jnp.maximum(jnp.sum(w), 1.0)
    if metric == "mse":
        diff = (v - r) * w
        return jnp.sum(diff * diff) / n
    if metric == "ncc":
        mv = jnp.sum(v * w) / n
        mr = jnp.sum(r * w) / n
        dv = (v - mv) * w
        dr = (r - mr) * w
        cov = jnp.sum(dv * dr)
        var = jnp.sum(dv * dv) * jnp.sum(dr * dr)
        return 1.0 - (cov * cov) / jnp.maximum(var, 1e-12)
    if metric == "mi":
        joint = _mi_joint(v, r, w, bins or _MI_BINS)
        p = joint / jnp.maximum(jnp.sum(joint), 1e-6)
        pr = jnp.sum(p, axis=1, keepdims=True)
        pm = jnp.sum(p, axis=0, keepdims=True)
        mi = jnp.sum(p * (jnp.log(p + 1e-12)
                          - jnp.log(pr * pm + 1e-12)))
        return -mi
    raise ValueError(f"unknown metric {metric!r}")


# dense (N, bins) Parzen matrices are ~4 GB per 32M-voxel volume; past
# this many values the joint histogram accumulates in rematerialized
# chunks instead (weights recomputed in the backward pass)
_MI_CHUNK = 1 << 21


def _mi_joint(v, r, w, bins=None):
    """(bins, bins) soft joint histogram. Small N: one matmul.
    Large N: lax.scan over _MI_CHUNK-value chunks with jax.checkpoint
    so neither pass materializes the (N, bins) weight matrices."""
    B = bins or _MI_BINS
    N = v.shape[0]
    if N <= _MI_CHUNK:
        Wr = _soft_bin_weights(r, B) * w[:, None]
        Wm = _soft_bin_weights(v, B)
        return _mm(Wr.T, Wm)
    C = -(-N // _MI_CHUNK)
    pad = C * _MI_CHUNK - N
    vp = jnp.pad(v, (0, pad))
    rp = jnp.pad(r, (0, pad))
    wp = jnp.pad(w, (0, pad))            # padded weights 0 -> no count

    @jax.checkpoint
    def body(acc, xs):
        vc, rc, wc = xs
        Wr = _soft_bin_weights(rc, B) * wc[:, None]
        Wm = _soft_bin_weights(vc, B)
        return acc + _mm(Wr.T, Wm), None

    xs = (vp.reshape(C, _MI_CHUNK), rp.reshape(C, _MI_CHUNK),
          wp.reshape(C, _MI_CHUNK))
    joint, _ = jax.lax.scan(body, jnp.zeros((B, B), jnp.float32), xs)
    return joint


@partial(jax.jit,
         static_argnames=("steps", "stride", "metric"))
def _register_level(ref_vol, mov_vol, ref_pix2pos, mov_pos2pix, center,
                    pose0, lr, steps, stride, intensity_scale=1.0,
                    metric="mse"):
    """One pyramid level of Adam descent on the selected masked
    similarity metric (see :func:`_metric_loss`).

    The level's volumes are first DOWNSAMPLED by `stride` (separable
    matrix contractions at Precision.HIGHEST) and the loss evaluates on
    the full contiguous low-res grid, which keeps the gathers local.

    Accepts any input dtype (int16 CT passes at half the f32 transfer
    cost — the host->device link is the bottleneck, not the cast)."""
    from ..ops.resample import _interp_matrix

    ref_vol = ref_vol.astype(jnp.float32) * intensity_scale
    mov_vol = mov_vol.astype(jnp.float32) * intensity_scale
    s = stride[0]
    if s > 1:
        def down(v):
            # per-volume matrices: ref and mov may live on DIFFERENT
            # grids (review finding: shared ref-shaped matrices crashed
            # any differing-shape pair)
            Z, Y, X = v.shape
            oz, oy, ox = max(Z // s, 2), max(Y // s, 2), max(X // s, 2)
            mz = jnp.asarray(_interp_matrix(oz, Z, Z / oz))
            my = jnp.asarray(_interp_matrix(oy, Y, Y / oy))
            mx = jnp.asarray(_interp_matrix(ox, X, X / ox))
            hi = jax.lax.Precision.HIGHEST
            out = jnp.einsum("ij,jyx->iyx", mz, v, precision=hi,
                             preferred_element_type=jnp.float32)
            out = jnp.einsum("kj,zjx->zkx", my, out, precision=hi,
                             preferred_element_type=jnp.float32)
            out = jnp.einsum("lj,zyj->zyl", mx, out, precision=hi,
                             preferred_element_type=jnp.float32)
            return out, (Z, Y, X), (oz, oy, ox)

        ref_vol, (Z, Y, X), (oz, oy, ox) = down(ref_vol)
        mov_vol, (MZf, MYf, MXf), (mzo, myo, mxo) = down(mov_vol)
        # low-res pixel i maps to full-res pixel i * (full/low)
        scale_ref = jnp.diag(jnp.asarray(
            [X / ox, Y / oy, Z / oz, 1.0], jnp.float32))
        ref_pix2pos = _mm(ref_pix2pos, scale_ref)
        inv_scale = jnp.diag(jnp.asarray(
            [mxo / MXf, myo / MYf, mzo / MZf, 1.0], jnp.float32))
        mov_pos2pix = _mm(inv_scale, mov_pos2pix)
        stride = (1, 1, 1)

    shape = ref_vol.shape
    scale = jnp.asarray(_pose_scale(pose0.shape[0]))

    from ..ops.resample import make_trilinear_sampler

    coords_pix = _sample_grid(shape, stride)                # (N, 3) xyz
    ones = jnp.ones((coords_pix.shape[0], 1), jnp.float32)
    coords_h = jnp.concatenate([coords_pix, ones], axis=1)
    ref_pos = _mm(coords_h, ref_pix2pos.T)                  # (N, 4)
    ref_vals = _trilinear_flat(ref_vol, coords_pix)
    sample_mov = make_trilinear_sampler(mov_vol, 0.0)

    def loss_fn(params):
        m = pose_to_matrix(params * scale, center)          # ref->mov
        mov_pos = _mm(ref_pos, m.T)                         # (N, 4)
        mov_pix = _mm(mov_pos, mov_pos2pix.T)
        vals = sample_mov(mov_pix[:, :3])
        inside = _inside_mask(mov_vol.shape, mov_pix[:, :3])
        return _metric_loss(metric, vals, ref_vals, inside)

    opt = optax.adam(lr)

    def step(carry, _):
        params, opt_state = carry
        loss, g = jax.value_and_grad(loss_fn)(params)
        updates, opt_state = opt.update(g, opt_state)
        params = optax.apply_updates(params, updates)
        return (params, opt_state), loss

    params0 = pose0 / scale
    (params, _), losses = jax.lax.scan(
        step, (params0, opt.init(params0)), None, length=steps)
    return params * scale, losses


def _trilinear_flat(vol, coords_xyz):
    from ..ops.resample import _trilinear
    return _trilinear(vol, coords_xyz, jnp.float32(0.0))


def _inside_mask(shape, coords_xyz):
    x, y, z = coords_xyz[:, 0], coords_xyz[:, 1], coords_xyz[:, 2]
    return ((x >= 0) & (x <= shape[2] - 1) & (y >= 0)
            & (y <= shape[1] - 1) & (z >= 0)
            & (z <= shape[0] - 1)).astype(jnp.float32)


def register_rigid_intensity_batch(refs, movs, ref_pix2pos, mov_pos2pix,
                                   centers, poses0=None,
                                   levels=((4, 60, 0.3), (2, 40, 0.1),
                                           (1, 25, 0.03)),
                                   intensity_scale=1.0, mesh=None,
                                   metric="mse", mode="rigid"):
    """Cohort registration: P volume pairs through ONE compiled program
    per pyramid level.

    A single chip runs pairs back-to-back inside ``lax.map`` (no
    per-pair dispatch); with ``mesh`` (a ('data', 'space') Mesh from
    parallel.mesh.make_mesh) the pair axis is sharded over 'data' via
    shard_map, so an 8-device mesh runs 8 independent descents at once —
    the batch-of-volumes scaling design from SURVEY §2.11. P must be
    divisible by the 'data' axis size; all pairs share one volume shape.

    refs, movs : (P, Z, Y, X) arrays (any real dtype; pre-normalized —
        see register_rigid_intensity's quantization for the recipe)
    ref_pix2pos, mov_pos2pix : (P, 4, 4) f32 geometry matrices
    centers : (P, 3) rotation centers (mm)
    Returns (poses (P, n_params), final_losses (P,)); n_params is 6/7/12
    per ``mode`` (see :func:`pose_to_matrix`).
    """
    import jax.numpy as jnp

    if mode not in _MODE_NPARAMS:
        raise ValueError(f"unknown mode {mode!r}; pick from "
                         f"{sorted(_MODE_NPARAMS)}")
    refs = jnp.asarray(refs)
    movs = jnp.asarray(movs)
    P_n = refs.shape[0]
    n_params = _MODE_NPARAMS[mode]
    if poses0 is not None and np.shape(poses0) != (P_n, n_params):
        raise ValueError(
            f"poses0 must have shape ({P_n}, {n_params}) for "
            f"mode={mode!r}, got {np.shape(poses0)}")
    ref_pix2pos = jnp.asarray(ref_pix2pos, jnp.float32)
    mov_pos2pix = jnp.asarray(mov_pos2pix, jnp.float32)
    centers = jnp.asarray(centers, jnp.float32)
    poses = (jnp.zeros((P_n, n_params), jnp.float32)
             if poses0 is None else jnp.asarray(poses0, jnp.float32))
    scale = jnp.float32(intensity_scale)
    losses = jnp.zeros((P_n,), jnp.float32)

    if metric == "mi":
        # the Parzen bins cover [0, 1] and clip has zero gradient
        # outside it: unnormalized (or signed-normalized) input on
        # EITHER side would silently no-op the registration. min/max
        # run on the stored dtype (no f32 cohort copy) and scale on
        # host; a blank all-zero volume is degenerate but harmless.
        s = float(intensity_scale)
        for name, arr in (("refs", refs), ("movs", movs)):
            lo = float(jnp.min(arr)) * s
            hi = float(jnp.max(arr)) * s
            # hard bound catches grossly unnormalized input (raw HU,
            # uint16); normalized-with-noise data legitimately pokes a
            # little outside [0, 1] (e.g. -0.03 noise floor) and gets
            # the out-of-range-fraction warning below instead
            # (ADVICE r2)
            if not (lo >= -0.05 and hi <= 1.5):
                raise ValueError(
                    "metric='mi' needs intensities normalized to "
                    f"[0, 1] (after intensity_scale; {name} span "
                    f"[{lo:.3g}, {hi:.3g}]) — see "
                    "register_rigid_intensity's normalize=True recipe")
            if lo < 0.0 or hi > 1.0:
                # inside the hard bound but outside [0,1]: those
                # voxels clip into the edge Parzen bins with zero
                # gradient — report how many are affected
                frac = float(jnp.mean(
                    ((arr * s) < 0.0) | ((arr * s) > 1.0)))
                if frac > 0:
                    import warnings
                    warnings.warn(
                        f"metric='mi': {frac:.2%} of {name} voxels "
                        "fall outside [0, 1] after intensity_scale "
                        "and will clip into zero-gradient edge Parzen "
                        "bins, weakening the registration",
                        stacklevel=2)

    for stride, steps, lr in levels:
        def level(r, m, rp, mp, c, p0):
            def one(args):
                ri, mi, rpi, mpi, ci, pi = args
                pose, ls = _register_level(
                    ri, mi, rpi, mpi, ci, pi, jnp.float32(lr),
                    int(steps), (int(stride),) * 3, scale,
                    metric=metric)
                return pose, ls[-1]
            return jax.lax.map(one, (r, m, rp, mp, c, p0))

        if mesh is not None:
            from jax.sharding import PartitionSpec as P

            spec = P("data")
            level = jax.shard_map(
                level, mesh=mesh,
                in_specs=(spec, spec, spec, spec, spec, spec),
                out_specs=(spec, spec))
        poses, losses = jax.jit(level)(refs, movs, ref_pix2pos,
                                       mov_pos2pix, centers, poses)
    return np.asarray(poses), np.asarray(losses)


_MODE_NPARAMS = {"rigid": 6, "similarity": 7, "affine": 12}


def register_rigid_intensity(reference_image, moving_image, pose0=None,
                             levels=((4, 60, 0.3), (2, 40, 0.1),
                                     (1, 25, 0.03)),
                             normalize=True, metric="mse",
                             mode="rigid"):
    """Register moving onto reference by gradient descent on a masked
    similarity metric.

    Parameters
    ----------
    reference_image, moving_image : objects with .array/.matrix/
        .spacing/.origin (Image instances or equivalents)
    levels : tuple of (stride, steps, lr) coarse-to-fine schedule
    metric : 'mse' (mono-modality default) | 'ncc' | 'mi' (soft-binned
        mutual information — the CT<->MR cross-modality metric,
        BASELINE config #4; requires normalize=True)
    mode : 'rigid' (6-DoF) | 'similarity' (+isotropic scale) |
        'affine' (12-DoF: +per-axis scales and shears) — the
        transform family, see :func:`pose_to_matrix`. Gradient
        descent through the same sampler drives all three; the
        returned matrix remains ``reference -> moving`` physical.
        CAVEAT for scale-bearing modes: ``normalize=True`` rescales
        each volume by its OWN 2/98 percentiles, which is not
        invariant under a volume-changing transform (a 6% shrink
        shifts the histogram) and biases the fitted scale by a few
        percent with 'mse' — use ``normalize=False`` or
        ``metric='ncc'`` (affine-intensity invariant) there.

    Returns (matrix4 ``reference -> moving``, info dict).
    """
    if metric == "mi" and not normalize:
        raise ValueError("metric='mi' requires normalize=True "
                         "([0, 1] intensities for the Parzen bins)")
    if mode not in _MODE_NPARAMS:
        raise ValueError(f"unknown mode {mode!r}; pick from "
                         f"{sorted(_MODE_NPARAMS)}")
    n_params = _MODE_NPARAMS[mode]
    if pose0 is not None and np.shape(pose0) != (n_params,):
        raise ValueError(
            f"pose0 must have shape ({n_params},) for mode={mode!r}, "
            f"got {np.shape(pose0)}")
    ref = np.asarray(reference_image.array, dtype=np.float32)
    mov = np.asarray(moving_image.array, dtype=np.float32)
    intensity_scale = 1.0
    if normalize:
        # quantize the [0,1]-normalized volumes to uint16 so half the
        # bytes cross the host->device link (dequant happens in-jit via
        # intensity_scale; 1.5e-5 quantization error << interp noise)
        def norm(a):
            lo, hi = np.percentile(a, [2, 98])
            a = np.clip((a - lo) / max(hi - lo, 1e-6), 0, 1)
            return (a * 65535.0 + 0.5).astype(np.uint16)
        ref = norm(ref)
        mov = norm(mov)
        intensity_scale = 1.0 / 65535.0

    ref_pix2pos = geo.pixel_to_position_matrix(
        reference_image.matrix, reference_image.spacing,
        reference_image.origin).astype(np.float32)
    mov_pos2pix = geo.position_to_pixel_matrix(
        moving_image.matrix, moving_image.spacing,
        moving_image.origin).astype(np.float32)
    center = np.asarray(reference_image.compute_center()
                        if hasattr(reference_image, "compute_center")
                        else geo.apply_homogeneous(
                            [ref.shape[2] / 2, ref.shape[1] / 2,
                             ref.shape[0] / 2], ref_pix2pos),
                        dtype=np.float32)

    pose = jnp.zeros(n_params, jnp.float32) if pose0 is None \
        else jnp.asarray(pose0, jnp.float32)
    losses_all = []
    refj = jnp.asarray(ref)
    movj = jnp.asarray(mov)
    for stride, steps, lr in levels:
        pose, losses = _register_level(
            refj, movj, jnp.asarray(ref_pix2pos),
            jnp.asarray(mov_pos2pix), jnp.asarray(center), pose,
            jnp.float32(lr), int(steps), (stride, stride, stride),
            jnp.float32(intensity_scale), metric=metric)
        losses_all.append(np.asarray(losses))

    matrix = np.asarray(pose_to_matrix(pose, jnp.asarray(center)),
                        dtype=np.float64)
    return matrix, {"pose": np.asarray(pose),
                    "loss": float(losses_all[-1][-1]),
                    "losses": losses_all}
