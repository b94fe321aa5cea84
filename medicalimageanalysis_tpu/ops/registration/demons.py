"""Demons deformable registration (device stencil iterations).

Device replacement for ITK's DemonsRegistrationFilter /
FastSymmetricForcesDemonsRegistrationFilter /
DiffeomorphicDemonsRegistrationFilter
(reference utils/deformable/simpleitk.py:178-256). Demons is pure
stencil + gather math — ideal XLA material: the whole iteration loop is
one fori_loop inside one jit, with per-iteration separable Gaussian
field smoothing as matrix contractions.

Update rule (Thirion, as in ITK): for difference D = f - m(x+u) and
gradient g (fixed grad, or symmetric mean for the fast variant):
    du = D * g / (|g|^2 + D^2 / K),  K = mean voxel spacing squared
Diffeomorphic composes exp(du) into the field instead of adding.

forces='lncc' swaps the Thirion update for ANTs-CC local normalized
cross-correlation gradient forces (Avants et al., MedIA 2008) — the
contrast-invariant metric for CT<->MR: all windowed moments are
separable box sums, the update rides the warped moving
gradient (the symmetric mean cancels under opposite contrast
polarity), and fluid-like smoothing precedes ANTs' gradient-step
normalization so noise-window spikes cannot starve the coherent
component.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp

from ..filters import _gauss_kernel_matrix
from ..warp import warp_disp
from .dvf import _compose_planar

__all__ = ["demons_registration"]


def _spatial_gradient_planar(vol, sp):
    """(3, Z, Y, X) planar gradient, rows (d/dx, d/dy, d/dz) / spacing."""
    gz, gy, gx = jnp.gradient(vol)
    return jnp.stack([gx / sp[0], gy / sp[1], gz / sp[2]])


def _smooth_field(u, mz, my, mx):
    """Separable Gaussian over a planar (3, Z, Y, X) field: one batched
    einsum per axis. HIGHEST keeps the field at f32 (the z-sharded twin
    in parallel/halo.py sums its z taps in f32; TF32 here would split
    the two trajectories)."""
    hi = jax.lax.Precision.HIGHEST
    out = jnp.einsum("ij,cjyx->ciyx", mz, u, precision=hi,
                     preferred_element_type=jnp.float32)
    out = jnp.einsum("kj,czjx->czkx", my, out, precision=hi,
                     preferred_element_type=jnp.float32)
    return jnp.einsum("lj,czyj->czyl", mx, out, precision=hi,
                      preferred_element_type=jnp.float32)


def _box_matrix(n, radius):
    """(n, n) banded ones matrix: applying it along an axis is the
    axis's windowed box sum (radius voxels each side)."""
    i = np.arange(n)
    return (np.abs(i[:, None] - i[None, :]) <= radius).astype(np.float32)


def _lncc_moments(vol, lz, ly, lx, cnt):
    """Windowed (mean-removed value, variance) of one volume."""
    mu = _box_sum(vol, lz, ly, lx) / cnt
    var = jnp.maximum(_box_sum(vol * vol, lz, ly, lx) / cnt - mu ** 2,
                      0.0)
    return vol - mu, var


def _lncc_force(i_a, var_a, i_b, var_b, cross, g_b, v_eps):
    """ANTs-CC gradient force pushing image b toward image a (Avants
    2008), riding b's own warped gradient g_b — the single shared
    formula for the demons and SyN cores."""
    base = 2.0 * cross / (var_a * var_b + v_eps)
    return (base * (i_a - cross / (var_b + v_eps) * i_b))[None] * g_b


def _box_sum(vol, bz, by, bx):
    """Separable windowed sum over a (Z, Y, X) volume (a box filter as
    three matrix contractions). Precision HIGHEST is load-bearing: the
    LNCC variances come from moment cancellation E[x^2] - E[x]^2, which
    reduced-precision matmul inputs (bf16, TF32) destroy."""
    hi = jax.lax.Precision.HIGHEST
    out = jnp.einsum("ij,jyx->iyx", bz, vol, precision=hi,
                     preferred_element_type=jnp.float32)
    out = jnp.einsum("kj,zjx->zkx", by, out, precision=hi,
                     preferred_element_type=jnp.float32)
    return jnp.einsum("lj,zyj->zyl", bx, out, precision=hi,
                      preferred_element_type=jnp.float32)


@partial(jax.jit,
         static_argnames=("iterations", "method", "smooth", "std_vox",
                          "forces", "lncc_radius"))
def _demons_core(fixed, moving, sp, std_vox, step, intensity_threshold,
                 iterations, method, smooth, elastic_lambda=0.2,
                 u0=None, forces="ssd", lncc_radius=3):
    """Returns dvf_mm (Z,Y,X,3).

    The whole iteration loop holds the field PLANAR (3, Z, Y, X) and
    warps through the displacement warp — no per-iteration channel
    transposes. sp (and the update math) stays in (x, y, z) component
    order along the leading axis."""

    grad_f = _spatial_gradient_planar(fixed, sp)
    K = jnp.mean(sp) ** 2
    spc = sp[:, None, None, None]              # (3,1,1,1) planar scale

    mz = jnp.asarray(_gauss_kernel_matrix(fixed.shape[0],
                                          max(float(std_vox), 1e-3)))
    my = jnp.asarray(_gauss_kernel_matrix(fixed.shape[1],
                                          max(float(std_vox), 1e-3)))
    mx = jnp.asarray(_gauss_kernel_matrix(fixed.shape[2],
                                          max(float(std_vox), 1e-3)))

    # the symmetric-forces variants (and LNCC, whose force rides the
    # moving gradient) warp the moving image AND its three gradient
    # components every iteration: batch all four through ONE warp
    # sharing coordinates
    symmetric = method in ("fast", "diffeomorphic", "biomechanical")
    if symmetric or forces == "lncc":
        grad_m = _spatial_gradient_planar(moving, sp)
        warp_stack = jnp.concatenate([moving[None], grad_m])
    else:
        warp_stack = moving[None]

    if forces == "lncc":
        # fixed-image local statistics are loop-invariant. GLOBAL
        # CENTERING is load-bearing numerics, not style: LNCC is
        # invariant to a constant image shift, and centering removes
        # the E[x^2] - E[x]^2 cancellation on large raw intensities —
        # uncentered, the f32 moment noise wobbles the peak-normalized
        # step by ~1e-3/iter, which is what made the z-sharded twin
        # visibly diverge from this path
        lz = jnp.asarray(_box_matrix(fixed.shape[0], lncc_radius))
        ly = jnp.asarray(_box_matrix(fixed.shape[1], lncc_radius))
        lx = jnp.asarray(_box_matrix(fixed.shape[2], lncc_radius))
        cnt = _box_sum(jnp.ones_like(fixed), lz, ly, lx)
        f_cent = fixed - jnp.mean(fixed)
        m_shift = jnp.mean(moving)
        i_f, var_f = _lncc_moments(f_cent, lz, ly, lx, cnt)
        mu_f = f_cent - i_f
        v_eps = 1e-5 * jnp.maximum(jnp.mean(var_f), 1e-12)

    def body(_, u_vox):                        # u_vox (3, Z, Y, X)
        w = warp_disp(warp_stack, u_vox, 0.0)
        warped = w[0]
        if forces == "lncc":
            # the CC force differentiates wrt the WARPED MOVING image:
            # its own gradient is the only correct carrier (the
            # symmetric mean 0.5(grad_f + grad_m) CANCELS under
            # opposite contrast polarity — measured: inverted-contrast
            # registration stalls entirely on the mean)
            g = w[1:4]
        elif symmetric:
            g = 0.5 * (grad_f + w[1:4])
        else:
            g = grad_f
        if forces == "lncc":
            # ANTs-CC gradient forces: maximize the local correlation
            # CC = cross^2 / (var_f var_m) — the cross-modality force
            # where SSD demons stalls. All windowed moments are
            # separable box sums.
            w_cent = warped - m_shift
            i_m, var_m = _lncc_moments(w_cent, lz, ly, lx, cnt)
            mu_m = w_cent - i_m
            cross = _box_sum(f_cent * w_cent, lz, ly, lx) / cnt \
                - mu_f * mu_m
            upd_mm = _lncc_force(i_f, var_f, i_m, var_m, cross, g,
                                 v_eps)
            # fluid-like regularization BEFORE normalization (ANTs'
            # update-field smoothing): raw CC forces in noise-flat
            # windows are random-signed spikes of signal magnitude —
            # smoothing first cancels them so the peak normalization
            # reflects the coherent component, not the spikes
            upd_mm = _smooth_field(upd_mm, mz, my, mx)
            # CC forces are dimensionless-per-mm: normalize the peak
            # update to `step` mm (ANTs' gradient-step normalization)
            max_norm = jnp.sqrt(
                jnp.max(jnp.sum(upd_mm * upd_mm, axis=0)))
            upd_mm = upd_mm * (step / jnp.maximum(max_norm, 1e-12))
        else:
            diff = fixed - warped
            g2 = jnp.sum(g * g, axis=0)
            denom = g2 + (diff * diff) / K
            active = (jnp.abs(diff) > intensity_threshold) \
                & (denom > 1e-9)
            upd_mm = jnp.where(
                active[None],
                (diff / jnp.maximum(denom, 1e-9))[None] * g, 0.0)
            if symmetric:
                max_norm = jnp.sqrt(
                    jnp.max(jnp.sum(upd_mm * upd_mm, axis=0)))
                scale = jnp.minimum(
                    1.0, step / jnp.maximum(max_norm, 1e-9))
                upd_mm = upd_mm * scale
        upd_vox = upd_mm / spc
        if method == "diffeomorphic":
            # exp(upd) via scaling and squaring (3 squarings)
            v = upd_vox / 8.0
            for _s in range(3):
                v = _compose_planar(v, v)
            u_new = _compose_planar(u_vox, v)
        else:
            u_new = u_vox + upd_vox
        if smooth:
            u_new = _smooth_field(u_new, mz, my, mx)
        if method == "biomechanical":
            # linear-elastic regularization (Navier-Cauchy gradient
            # step): tissue-like near-incompressibility by relaxing the
            # field against grad(div u) — a pure central-difference
            # stencil, ideal XLA material. The reference's
            # compute_biomechanical is an empty stub
            # (structure/deformable.py:536-540); this implements the
            # capability it reserved.
            # dE/du of E = 1/2 (div u)^2 is -grad(div u), so descent
            # ADDS lambda * grad(div u)
            div = (jnp.gradient(u_new[0], axis=2)
                   + jnp.gradient(u_new[1], axis=1)
                   + jnp.gradient(u_new[2], axis=0))
            u_new = u_new + elastic_lambda * jnp.stack(
                [jnp.gradient(div, axis=2), jnp.gradient(div, axis=1),
                 jnp.gradient(div, axis=0)])
        return u_new

    if u0 is None:
        u0 = jnp.zeros((3,) + fixed.shape, jnp.float32)
    u = jax.lax.fori_loop(0, iterations, body, u0)
    return jnp.moveaxis(u, 0, -1) * sp         # voxels -> mm


@partial(jax.jit,
         static_argnames=("iterations", "smooth", "std_vox", "forces",
                          "lncc_radius"))
def _syn_core(fixed, moving, sp, std_vox, step, intensity_threshold,
              iterations, smooth, forces, lncc_radius,
              u1_0=None, u2_0=None):
    """Greedy SyN (Avants et al., MedIA 2008): two diffeomorphic
    half-maps phi1 (from the fixed side) and phi2 (from the moving
    side) evolve toward the common midpoint — each iteration warps
    BOTH images to the middle, computes opposing forces there, and
    composes each half with the exponential of its own (smoothed,
    step-normalized) update. Returns the half-fields
    (u1_mm, u2_mm (Z,Y,X,3)); the caller assembles the full
    inverse-consistent map u2 o u1^{-1} through the canonical
    invert_dvf, once, at full resolution."""

    grad_f = _spatial_gradient_planar(fixed, sp)
    grad_m = _spatial_gradient_planar(moving, sp)
    stack_f = jnp.concatenate([fixed[None], grad_f])
    stack_m = jnp.concatenate([moving[None], grad_m])
    K = jnp.mean(sp) ** 2
    spc = sp[:, None, None, None]
    half = 0.5 * step

    mz = jnp.asarray(_gauss_kernel_matrix(fixed.shape[0],
                                          max(float(std_vox), 1e-3)))
    my = jnp.asarray(_gauss_kernel_matrix(fixed.shape[1],
                                          max(float(std_vox), 1e-3)))
    mx = jnp.asarray(_gauss_kernel_matrix(fixed.shape[2],
                                          max(float(std_vox), 1e-3)))
    if forces == "lncc":
        lz = jnp.asarray(_box_matrix(fixed.shape[0], lncc_radius))
        ly = jnp.asarray(_box_matrix(fixed.shape[1], lncc_radius))
        lx = jnp.asarray(_box_matrix(fixed.shape[2], lncc_radius))
        cnt = _box_sum(jnp.ones_like(fixed), lz, ly, lx)
        # global centering constants (LNCC shift-invariance; kills the
        # f32 moment cancellation — see _demons_core)
        f_shift = jnp.mean(fixed)
        m_shift = jnp.mean(moving)

    def _exp(upd_vox):
        # exp via scaling and squaring (3 squarings)
        v = upd_vox / 8.0
        for _s in range(3):
            v = _compose_planar(v, v)
        return v

    def _normalize(upd_mm, ssd_cap_only):
        max_norm = jnp.sqrt(jnp.max(jnp.sum(upd_mm * upd_mm, axis=0)))
        if ssd_cap_only:
            scale = jnp.minimum(1.0, half / jnp.maximum(max_norm, 1e-9))
        else:
            scale = half / jnp.maximum(max_norm, 1e-12)
        return upd_mm * scale

    def body(_, carry):
        u1, u2 = carry
        wf = warp_disp(stack_f, u1, 0.0)
        wm = warp_disp(stack_m, u2, 0.0)
        fw, gfw = wf[0], wf[1:4]
        mw, gmw = wm[0], wm[1:4]
        if forces == "lncc":
            fw_c = fw - f_shift
            mw_c = mw - m_shift
            i_fw, var_fw = _lncc_moments(fw_c, lz, ly, lx, cnt)
            i_mw, var_mw = _lncc_moments(mw_c, lz, ly, lx, cnt)
            cross = _box_sum(fw_c * mw_c, lz, ly, lx) / cnt \
                - (fw_c - i_fw) * (mw_c - i_mw)
            v_eps = 1e-5 * jnp.maximum(jnp.mean(var_fw), 1e-12)
            f_m = _lncc_force(i_fw, var_fw, i_mw, var_mw, cross, gmw,
                              v_eps)
            f_f = _lncc_force(i_mw, var_mw, i_fw, var_fw, cross, gfw,
                              v_eps)
            f_m = _normalize(_smooth_field(f_m, mz, my, mx), False)
            f_f = _normalize(_smooth_field(f_f, mz, my, mx), False)
        else:
            diff = fw - mw
            active = jnp.abs(diff) > intensity_threshold
            den_m = jnp.sum(gmw * gmw, axis=0) + diff * diff / K
            f_m = jnp.where(
                (active & (den_m > 1e-9))[None],
                (diff / jnp.maximum(den_m, 1e-9))[None] * gmw, 0.0)
            den_f = jnp.sum(gfw * gfw, axis=0) + diff * diff / K
            f_f = jnp.where(
                (active & (den_f > 1e-9))[None],
                (-diff / jnp.maximum(den_f, 1e-9))[None] * gfw, 0.0)
            f_m = _normalize(f_m, True)
            f_f = _normalize(f_f, True)
        u1n = _compose_planar(u1, _exp(f_f / spc))
        u2n = _compose_planar(u2, _exp(f_m / spc))
        if smooth:
            u1n = _smooth_field(u1n, mz, my, mx)
            u2n = _smooth_field(u2n, mz, my, mx)
        return u1n, u2n

    zero = jnp.zeros((3,) + fixed.shape, jnp.float32)
    u1 = zero if u1_0 is None else u1_0
    u2 = zero if u2_0 is None else u2_0
    u1, u2 = jax.lax.fori_loop(0, iterations, body, (u1, u2))
    return jnp.moveaxis(u1, 0, -1) * sp, jnp.moveaxis(u2, 0, -1) * sp


def _downsample_volume(vol, factor):
    from ..resample import separable_resample
    Z, Y, X = vol.shape
    out = (max(Z // factor, 2), max(Y // factor, 2), max(X // factor, 2))
    return separable_resample(vol, out)


def _upsample_field(u_mm, out_shape):
    """Planar-free field upsample: each mm component is resolution-
    independent, so a separable trilinear resample per channel is
    exact pyramid prolongation."""
    from ..resample import separable_resample
    return jnp.stack([separable_resample(u_mm[..., c], out_shape)
                      for c in range(3)], axis=-1)


def demons_registration(fixed, moving, spacing_xyz=(1.0, 1.0, 1.0),
                        method="demons", smooth=True, std=1,
                        iterations=50, intensity_threshold=0.001,
                        step=2.0, elastic_lambda=0.2, pyramid=None,
                        forces="ssd", lncc_radius=3):
    """Run a demons variant; returns (Z, Y, X, 3) DVF in mm such that
    moving(x + d(x)) ~ fixed(x) on the fixed grid.

    method: 'demons' | 'fast' | 'diffeomorphic' — mirrors the three ITK
    filters the reference selects between (reference
    structure/deformable.py:677-690) — plus 'biomechanical': symmetric
    forces with a linear-elastic grad(div u) relaxation step
    (weight ``elastic_lambda``) for tissue-like near-incompressibility
    (the reference reserved this as an empty stub) — plus 'syn':
    BEYOND-PARITY greedy SyN (ANTs' flagship): two diffeomorphic
    half-maps meet at the midpoint, inverse-consistent by
    construction; the returned field is u2 o u1^{-1} on the fixed
    grid (same contract as every other method). Pairs naturally with
    forces='lncc' (the ANTs CC+SyN combination).

    forces: 'ssd' (Thirion intensity-difference update, the ITK
    behavior) | 'lncc' — BEYOND-PARITY: ANTs-CC local normalized
    cross-correlation gradient forces (windowed radius ``lncc_radius``
    voxels), contrast-invariant so CT<->MR / cross-sequence MR pairs
    register without prior histogram matching; every update is
    normalized to ``step`` mm peak displacement (ANTs' gradient-step
    normalization — raw CC gradients carry no mm scale). Composes with
    any ``method`` (additive, diffeomorphic, elastic).

    pyramid: optional coarse-to-fine downsample factors, e.g. (4, 2, 1)
    — beyond-parity multi-resolution schedule (the reference's
    single-level sitk filters stall on large deformations). Each level
    runs ``iterations`` iterations on the downsampled pair, warm-
    started from the previous level's upsampled mm field (mm components
    are resolution-independent). The final factor should be 1.
    """
    if forces not in ("ssd", "lncc"):
        raise ValueError(f"demons: forces must be 'ssd' or 'lncc', "
                         f"got {forces!r}")
    method = str(method).lower()
    if method not in ("demons", "fast", "diffeomorphic",
                      "biomechanical", "syn"):
        raise ValueError(f"demons: unknown method {method!r}")
    fixed = jnp.asarray(fixed, dtype=jnp.float32)
    moving = jnp.asarray(moving, dtype=jnp.float32)
    sp = jnp.asarray(spacing_xyz, dtype=jnp.float32)
    syn = method == "syn"

    if pyramid:
        pyramid = tuple(int(f) for f in pyramid)
        if pyramid[-1] != 1:
            # the contract is a fixed-grid (Z, Y, X, 3) field: always
            # finish at full resolution
            pyramid = pyramid + (1,)
    else:
        pyramid = (1,)
    out_mm = None
    halves_mm = None                     # (u1_mm, u2_mm) for syn
    for factor in pyramid:
        if int(factor) > 1:
            f_l = _downsample_volume(fixed, int(factor))
            m_l = _downsample_volume(moving, int(factor))
        else:
            f_l, m_l = fixed, moving
        # physical voxel size grows with the factor
        ratio = jnp.asarray(
            [fixed.shape[2] / f_l.shape[2],
             fixed.shape[1] / f_l.shape[1],
             fixed.shape[0] / f_l.shape[0]], jnp.float32)
        sp_l = sp * ratio
        if syn:
            u1_0 = u2_0 = None
            if halves_mm is not None:
                ups = [_upsample_field(jnp.asarray(h), f_l.shape)
                       for h in halves_mm]
                u1_0, u2_0 = [jnp.moveaxis(u / sp_l, -1, 0)
                              for u in ups]
            halves_mm = _syn_core(
                f_l, m_l, sp_l, float(std), jnp.float32(step),
                jnp.float32(intensity_threshold), int(iterations),
                bool(smooth), forces, int(lncc_radius),
                u1_0=u1_0, u2_0=u2_0)
        else:
            u0 = None
            if out_mm is not None:
                up = _upsample_field(jnp.asarray(out_mm), f_l.shape)
                u0 = jnp.moveaxis(up / sp_l, -1, 0)      # mm -> voxels
            out_mm = _demons_core(
                f_l, m_l, sp_l, float(std), jnp.float32(step),
                jnp.float32(intensity_threshold), int(iterations),
                method, bool(smooth), jnp.float32(elastic_lambda),
                u0=u0, forces=forces, lncc_radius=int(lncc_radius))
    if syn:
        # full map: x -> phi2(phi1^{-1}(x)); with w = u1^{-1},
        # d = w + u2(x + w) = compose(u2, w); the inversion runs only
        # once, at full resolution
        from .dvf import compose_dvf, invert_dvf
        u1_np, u2_np = [np.asarray(h) for h in halves_mm]
        sp_np = np.asarray(spacing_xyz, np.float32)
        w = invert_dvf(u1_np, sp_np)
        out = compose_dvf(u2_np, w, sp_np)
    else:
        out = out_mm
    return np.asarray(out)
