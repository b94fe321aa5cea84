"""B-spline free-form deformable registration (device).

Device replacement for the SimpleITK B-spline registration path
(reference utils/deformable/simpleitk.py:96-129): a cubic B-spline
control grid (default 50 mm spacing like the reference) is densified to
a displacement field through three separable basis-matrix contractions,
the masked-MSE loss differentiates through the trilinear warp,
and Adam iterations run as one lax.scan inside one jit.
"""

from __future__ import annotations

from functools import partial

import numpy as np

import jax
import jax.numpy as jnp
import optax

__all__ = ["bspline_registration", "bspline_basis_matrix",
           "elastix_registration"]


def _cubic_bspline(t):
    """Uniform cubic B-spline basis values for fractional offsets t in
    [0,1): weights for control points floor(u)-1 .. floor(u)+2."""
    t2 = t * t
    t3 = t2 * t
    b0 = (1 - t) ** 3 / 6.0
    b1 = (3 * t3 - 6 * t2 + 4) / 6.0
    b2 = (-3 * t3 + 3 * t2 + 3 * t + 1) / 6.0
    b3 = t3 / 6.0
    return b0, b1, b2, b3


def bspline_basis_matrix(n_vox, n_ctrl, ctrl_spacing_vox):
    """(n_vox, n_ctrl) dense cubic B-spline evaluation matrix.

    Control point j sits at position (j - 1) * ctrl_spacing_vox (one
    phantom point before the volume, ITK initializer style)."""
    m = np.zeros((n_vox, n_ctrl), dtype=np.float32)
    for x in range(n_vox):
        u = x / ctrl_spacing_vox
        i = int(np.floor(u))
        t = u - i
        weights = _cubic_bspline(np.float64(t))
        for k, w in enumerate(weights):
            j = i + k  # control index offset: ctrl j covers grid i-1..i+2
            if 0 <= j < n_ctrl:
                m[x, j] = w
    return m


@partial(jax.jit,
         static_argnames=("steps", "with_mmask", "metric", "bins",
                          "with_base"))
def _bspline_fit(fixed, moving, fixed_mask, moving_mask, Bz, By, Bx,
                 sp, lr, steps, with_mmask=False, metric="mse", bins=32,
                 with_base=False, base_mm=None):
    # the moving-image mask (ITK semantics: a sample only contributes
    # where the warped moving mask is on) warps through the SAME kernel
    # call as the image, batched
    stack = jnp.stack([moving, moving_mask]) if with_mmask \
        else moving[None]
    # exact trilinear displacement sampler with the analytic VJP:
    # gradients flow disp -> control points through the separable
    # basis einsums
    from ..warp import make_disp_sampler
    sample_disp = make_disp_sampler(stack, 0.0)

    spc = sp[:, None, None, None]

    def densify(ctrl):
        # ctrl (3, Gz, Gy, Gx) planar -> (3, Z, Y, X) via separable
        # contractions (channel axis leads: no per-step transposes)
        out = jnp.einsum("zg,cgyx->czyx", Bz, ctrl,
                         preferred_element_type=jnp.float32)
        out = jnp.einsum("yh,czhx->czyx", By, out,
                         preferred_element_type=jnp.float32)
        out = jnp.einsum("xk,czyk->czyx", Bx, out,
                         preferred_element_type=jnp.float32)
        return out

    def total_disp(ctrl):
        d = densify(ctrl)                      # (3, Z, Y, X) mm
        if with_base:
            d = d + base_mm
        return d

    def loss_fn(ctrl):
        d = total_disp(ctrl)
        w_all = sample_disp(d / spc)
        warped = w_all[0]
        w = fixed_mask * w_all[1] if with_mmask else fixed_mask
        if metric == "mse":
            diff = (fixed - warped) * w
            sim = jnp.sum(diff * diff) / jnp.maximum(jnp.sum(w), 1.0)
        else:
            # Mattes-MI / NCC via the shared Parzen machinery (elastix
            # parity, reference simpleitk.py:131-176 metric selection)
            from ...models.rigid_intensity import _metric_loss
            sim = _metric_loss(metric, warped, fixed, w, bins=bins)
        # light bending-energy regularizer keeps the field smooth
        reg = jnp.mean(jnp.square(jnp.diff(ctrl, axis=1))) \
            + jnp.mean(jnp.square(jnp.diff(ctrl, axis=2))) \
            + jnp.mean(jnp.square(jnp.diff(ctrl, axis=3)))
        return sim + 1e-3 * reg

    opt = optax.adam(lr)
    ctrl0 = jnp.zeros((3, Bz.shape[1], By.shape[1], Bx.shape[1]),
                      jnp.float32)

    def step(carry, _):
        ctrl, opt_state = carry
        loss, g = jax.value_and_grad(loss_fn)(ctrl)
        updates, opt_state = opt.update(g, opt_state)
        ctrl = optax.apply_updates(ctrl, updates)
        return (ctrl, opt_state), loss

    (ctrl, _), losses = jax.lax.scan(step, (ctrl0, opt.init(ctrl0)),
                                     None, length=steps)
    return jnp.moveaxis(total_disp(ctrl), 0, -1), losses


def bspline_registration(fixed, moving, spacing_xyz=(1.0, 1.0, 1.0),
                         control_spacing=None, mesh_size=None,
                         iterations=100, lr=0.5, fixed_mask=None,
                         moving_mask=None):
    """Fit a cubic B-spline FFD; returns ((Z,Y,X,3) DVF mm, losses).

    `control_spacing` in mm (default [50,50,50] like reference
    simpleitk.py:106-107); `mesh_size` overrides the grid resolution.
    The returned field is the *sampling* field: moving(x + d(x)) ~
    fixed(x). `moving_mask` (ITK semantics) warps with the image and
    gates the loss where the warped mask is on.
    """
    fixed = np.asarray(fixed, dtype=np.float32)
    moving = np.asarray(moving, dtype=np.float32)
    Z, Y, X = fixed.shape
    sp = np.asarray(spacing_xyz, dtype=np.float32)

    if control_spacing is None:
        control_spacing = [50.0, 50.0, 50.0]
    if mesh_size is None:
        physical = [X * sp[0], Y * sp[1], Z * sp[2]]
        mesh_size = [max(1, int(psz / csp))
                     for psz, csp in zip(physical, control_spacing)]
    # control grid: mesh_size spans + 3 (cubic support), per axis (x,y,z)
    gx, gy, gz = (int(m) + 3 for m in mesh_size)
    csx = X / max(mesh_size[0], 1)
    csy = Y / max(mesh_size[1], 1)
    csz = Z / max(mesh_size[2], 1)

    Bx = jnp.asarray(bspline_basis_matrix(X, gx, csx))
    By = jnp.asarray(bspline_basis_matrix(Y, gy, csy))
    Bz = jnp.asarray(bspline_basis_matrix(Z, gz, csz))

    fmask = np.ones_like(fixed) if fixed_mask is None \
        else np.asarray(fixed_mask, dtype=np.float32)
    with_mmask = moving_mask is not None
    mmask = np.asarray(moving_mask, np.float32) if with_mmask \
        else np.zeros((1, 1, 1), np.float32)     # dummy: not transferred

    args = (jnp.asarray(fixed), jnp.asarray(moving), jnp.asarray(fmask),
            jnp.asarray(mmask), Bz, By, Bx, jnp.asarray(sp),
            jnp.float32(lr), int(iterations))
    dvf, losses = _bspline_fit(*args, with_mmask=with_mmask)
    return np.asarray(dvf), np.asarray(losses)


_ELASTIX_METRICS = {
    "AdvancedMeanSquares": "mse",
    "AdvancedMattesMutualInformation": "mi",
    "AdvancedNormalizedCorrelation": "ncc",
}

_ELASTIX_LINEAR_MODES = {
    "TranslationTransform": "rigid",
    "EulerTransform": "rigid",
    "SimilarityTransform": "similarity",
    "AffineTransform": "affine",
}


def _pm_flat(pm):
    """Elastix-style values are one-element string lists; flatten."""
    return {k: (v[0] if isinstance(v, (list, tuple)) else v)
            for k, v in dict(pm).items()}


def _linear_levels(resolutions, iterations):
    """Coarse-to-fine (stride, steps, lr) schedule for a linear stage
    from its elastix NumberOfResolutions / MaximumNumberOfIterations."""
    res = int(max(1, min(int(resolutions), 4)))
    steps = int(max(10, min(int(iterations), 400) // res))
    return tuple((2 ** (res - 1 - lev), steps, 0.3 * (0.33 ** lev))
                 for lev in range(res))


def _elastix_staged(fixed, moving, spacing_xyz, stages, metric, bins,
                    iterations, fixed_mask, moving_mask):
    """Elastix multi-stage parameter maps (the SimpleElastix vector-of-
    maps form the reference's path accepts,
    /root/reference/medicalimageanalysis/utils/deformable/simpleitk.py:131-176):
    linear stage(s) — Translation/Euler/Similarity/Affine, run on the
    rigid_intensity descent — warm-start the final BSpline stage. All
    stages compose into ONE point-displacement field on the fixed
    grid:  moving(M @ (p + b(p))) ~ fixed(p),  so
    d(p) = M (p + b(p)) - p  with M the composed linear matrix
    (fixed -> moving physical) and b the B-spline field fitted between
    fixed and the M-resampled moving."""
    from ...models.rigid_intensity import register_rigid_intensity
    from ..resample import affine_resample

    fixed = np.asarray(fixed, np.float32)
    moving = np.asarray(moving, np.float32)
    sp = np.asarray(spacing_xyz, np.float64).reshape(-1)
    S = np.diag([sp[0], sp[1], sp[2], 1.0])
    Sinv = np.linalg.inv(S)

    class _Grid:
        """Minimal image-like shim: both volumes share the fixed grid
        (identity orientation, origin 0) by the time they reach the
        registration ops."""

        def __init__(self, arr):
            self.array = arr
            self.matrix = np.eye(3)
            self.spacing = sp.copy()
            self.origin = np.zeros(3)

    kinds = [st.get("Transform", "BSplineTransform") for st in stages]
    for k in kinds:
        if k != "BSplineTransform" and k not in _ELASTIX_LINEAR_MODES:
            raise ValueError(f"elastix: unsupported Transform {k!r}")
    if kinds.count("BSplineTransform") > 1:
        raise ValueError("elastix: at most one BSplineTransform stage")
    if "BSplineTransform" in kinds \
            and kinds.index("BSplineTransform") != len(kinds) - 1:
        raise ValueError("elastix: the BSplineTransform stage must be "
                         "last")

    M_total = np.eye(4)
    mov_cur = moving
    mmask_cur = (None if moving_mask is None
                 else np.asarray(moving_mask, np.float32))
    bg = float(moving.min())
    b_field = None
    losses_all = []
    for st in stages:
        kind = st.get("Transform", "BSplineTransform")
        if kind in _ELASTIX_LINEAR_MODES:
            st_metric = _ELASTIX_METRICS.get(str(st.get("Metric", "")),
                                             metric)
            levels = _linear_levels(
                st.get("NumberOfResolutions", 3),
                st.get("MaximumNumberOfIterations", 120))
            mode = _ELASTIX_LINEAR_MODES[kind]
            # elastix's AutomaticTransformInitialization (default on):
            # FFT phase-correlation translation on GRADIENT MAGNITUDES
            # (contrast-inversion invariant — raw cross-modality
            # intensities flip the cross-power peak) seeds the descent;
            # any offset up to half the field of view is captured in
            # one device program
            pose0 = None
            auto_init = str(st.get("AutomaticTransformInitialization",
                                   "true")).lower() != "false"
            # phase correlation needs matching grids; differing-shape
            # pairs skip the seed (the descent still runs — review
            # finding: this raised on any CT<->MR size mismatch)
            if auto_init and fixed.shape != mov_cur.shape:
                auto_init = False
            if auto_init and np.allclose(M_total, np.eye(4)):
                from ...models.rigid_intensity import _MODE_NPARAMS
                from .phase_correlation import phase_correlation

                def gmag(a):
                    gz, gy, gx = np.gradient(np.asarray(a, np.float64))
                    return np.sqrt(gz * gz + gy * gy + gx * gx)

                shift, peak = phase_correlation(
                    gmag(fixed), gmag(mov_cur), spacing_xyz=sp)
                if peak > 0.02:
                    pose0 = np.zeros(_MODE_NPARAMS[mode], np.float32)
                    pose0[3:6] = shift[::-1]  # (z,y,x) mm -> (x,y,z)
            mat, info = register_rigid_intensity(
                _Grid(fixed), _Grid(mov_cur), metric=st_metric,
                mode=mode, pose0=pose0, levels=levels)
            losses_all.append(np.float32([info["loss"]]))
            # mov_cur(p) = moving(M_total p) and the stage matched
            # mov_cur(mat p) to fixed(p): compose right
            M_total = M_total @ mat
            P = Sinv @ M_total @ S  # fixed voxel -> moving voxel
            mov_cur = np.asarray(affine_resample(
                moving, P, fixed.shape, background=bg))
            # warp the moving-domain mask with the image (ITK Mattes
            # semantics) so the B-spline stage never scores the
            # resample fill; a ones-mask stands in when none given
            base_mask = (np.ones_like(moving) if moving_mask is None
                         else np.asarray(moving_mask, np.float32))
            mmask_cur = (np.asarray(affine_resample(
                base_mask, P, fixed.shape, background=0.0))
                > 0.5).astype(np.float32)
        else:
            dvf, losses = elastix_registration(
                fixed, mov_cur, spacing_xyz=sp, parameter_map=st,
                metric=metric, bins=bins, iterations=iterations,
                fixed_mask=fixed_mask, moving_mask=mmask_cur)
            b_field = np.asarray(dvf, np.float64)
            losses_all.append(np.asarray(losses, np.float32).ravel())

    Z, Y, X = fixed.shape
    p = np.empty((Z, Y, X, 3), np.float64)
    p[..., 0] = (np.arange(X) * sp[0])[None, None, :]
    p[..., 1] = (np.arange(Y) * sp[1])[None, :, None]
    p[..., 2] = (np.arange(Z) * sp[2])[:, None, None]
    q = p if b_field is None else p + b_field
    R = M_total[:3, :3]
    t = M_total[:3, 3]
    d = (q @ R.T + t) - p
    losses = (np.concatenate(losses_all) if losses_all
              else np.zeros(0, np.float32))
    return d.astype(np.float32), losses


def elastix_registration(fixed, moving, spacing_xyz=(1.0, 1.0, 1.0),
                         parameter_map=None, metric="mi", bins=32,
                         resolutions=4, final_grid_spacing=10.0,
                         iterations=256, lr=0.25, fixed_mask=None,
                         moving_mask=None):
    """Elastix-parity multi-resolution B-spline registration.

    Mirrors the schedule the reference gets from SimpleElastix's
    "nonrigid" default parameter map (reference
    utils/deformable/simpleitk.py:131-176): ``resolutions`` levels
    coarse-to-fine with both the image and the control grid halving in
    resolution per level (grid spacing = final_grid_spacing * 2^l),
    Mattes mutual information (default; Parzen joint histogram as a
    matrix product, shared with the rigid MI metric) or mean-squares /
    normalized-correlation, and ``iterations`` optimizer steps per
    level. Each level warm-starts additively from the previous level's
    field: loss(ctrl) = metric(fixed_l, moving(x + base_mm + B ctrl)),
    so the prolongation is exact (mm components are
    resolution-independent).

    ``parameter_map`` accepts the elastix keys the reference exposes
    (values may be elastix-style one-element string lists): Metric,
    NumberOfHistogramBins, NumberOfResolutions,
    FinalGridSpacingInPhysicalUnits, MaximumNumberOfIterations —
    or a SEQUENCE of stage maps (SimpleElastix's multi-stage form,
    keyed by Transform: Translation/Euler/Similarity/Affine stages
    warm-starting a final BSplineTransform stage; see
    :func:`_elastix_staged`). Returns ((Z, Y, X, 3) DVF mm, losses)
    like bspline_registration; for staged maps the DVF composes every
    stage.
    """
    if parameter_map is not None and isinstance(
            parameter_map, (list, tuple)):
        return _elastix_staged(fixed, moving, spacing_xyz,
                               [_pm_flat(p) for p in parameter_map],
                               metric=metric, bins=bins,
                               iterations=iterations,
                               fixed_mask=fixed_mask,
                               moving_mask=moving_mask)
    if parameter_map:
        pm = {k: (v[0] if isinstance(v, (list, tuple)) else v)
              for k, v in dict(parameter_map).items()}
        if "Metric" in pm:
            metric = _ELASTIX_METRICS.get(str(pm["Metric"]), metric)
        bins = int(pm.get("NumberOfHistogramBins", bins))
        resolutions = int(pm.get("NumberOfResolutions", resolutions))
        final_grid_spacing = float(
            pm.get("FinalGridSpacingInPhysicalUnits", final_grid_spacing))
        iterations = int(pm.get("MaximumNumberOfIterations", iterations))

    fixed = np.asarray(fixed, np.float32)
    moving = np.asarray(moving, np.float32)
    if metric == "mi":
        # Mattes bins each image over its own range: normalize
        # independently to [0, 1] (zero-range volumes stay flat)
        def norm(a):
            lo, hi = float(a.min()), float(a.max())
            return (a - lo) / (hi - lo) if hi > lo else a * 0.0
        fixed = norm(fixed)
        moving = norm(moving)

    sp_full = np.asarray(spacing_xyz, np.float32)
    from .demons import _downsample_volume, _upsample_field

    base_mm = None
    losses_all = []
    for lev in range(int(resolutions)):
        factor = 2 ** (int(resolutions) - 1 - lev)
        if factor > 1:
            f_l = np.asarray(_downsample_volume(fixed, factor))
            m_l = np.asarray(_downsample_volume(moving, factor))
        else:
            f_l, m_l = fixed, moving
        ratio = np.asarray([fixed.shape[2] / f_l.shape[2],
                            fixed.shape[1] / f_l.shape[1],
                            fixed.shape[0] / f_l.shape[0]], np.float32)
        sp_l = sp_full * ratio
        fm_l = np.ones_like(f_l) if fixed_mask is None else np.asarray(
            _downsample_volume(np.asarray(fixed_mask, np.float32),
                               factor) if factor > 1
            else np.asarray(fixed_mask, np.float32))
        # MI/NCC must EXCLUDE out-of-domain samples, not see the fill
        # value: a 0.0 fill is a legitimate intensity bin (for
        # inverted-contrast MR it is the TISSUE bin), so an ungated
        # histogram metric can "improve" by pushing samples out of
        # bounds (measured: MI rises while the field diverges). Warp a
        # ones-mask (ITK Mattes semantics) when no moving mask given.
        need_domain_mask = metric != "mse"
        with_mmask = moving_mask is not None or need_domain_mask
        if moving_mask is not None:
            mm = np.asarray(moving_mask, np.float32)
            mm_l = np.asarray(_downsample_volume(mm, factor)) \
                if factor > 1 else mm
        elif need_domain_mask:
            mm_l = np.ones_like(m_l)
        else:
            mm_l = np.zeros((1, 1, 1), np.float32)

        Zl, Yl, Xl = f_l.shape
        grid_mm = final_grid_spacing * factor
        mesh = [max(1, int(n * s / grid_mm))
                for n, s in zip((Xl, Yl, Zl), sp_l)]
        gx, gy, gz = (int(m) + 3 for m in mesh)
        Bx = jnp.asarray(bspline_basis_matrix(Xl, gx, Xl / mesh[0]))
        By = jnp.asarray(bspline_basis_matrix(Yl, gy, Yl / mesh[1]))
        Bz = jnp.asarray(bspline_basis_matrix(Zl, gz, Zl / mesh[2]))

        with_base = base_mm is not None
        base_l = None
        if with_base:
            up = _upsample_field(jnp.asarray(base_mm), f_l.shape)
            base_l = jnp.moveaxis(up, -1, 0)           # planar mm

        fit_args = (jnp.asarray(f_l), jnp.asarray(m_l),
                    jnp.asarray(fm_l), jnp.asarray(mm_l), Bz, By, Bx,
                    jnp.asarray(sp_l), jnp.float32(lr), int(iterations))
        fit_kw = dict(with_mmask=with_mmask, metric=metric,
                      bins=int(bins), with_base=with_base,
                      base_mm=base_l)
        dvf, losses = _bspline_fit(*fit_args, **fit_kw)

        base_mm = dvf                                   # (Zl,Yl,Xl,3) mm
        losses_all.append(np.asarray(losses))

    return np.asarray(base_mm, np.float32), np.concatenate(losses_all)
