"""Batched, shardable volume pipelines.

The flagship compute paths, expressed over a (B, Z, Y, X) batch so a
whole patient cohort runs in one jitted program:

- :func:`preprocess_batch` — fused rescale -> FFS -> isotropic separable
  resample -> Gaussian -> external-threshold mask.
- :func:`registration_train_step` — one optimizer step of batched 6-DoF
  intensity registration (the multichip "training step": volumes sharded
  over ('data', 'space'), poses over 'data').
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp

from ..ops.filters import _gauss_kernel_matrix
from ..ops.resample import _interp_matrix

__all__ = ["make_preprocess_fn", "make_registration_step",
           "preprocess_batch", "demons_batch",
           "compare_masks_batch", "dvh_batch", "gamma_batch",
           "radiomics_batch", "n4_batch", "rasterize_batch"]


def make_preprocess_fn(in_shape, out_shape, ffs_op="ax_rot2",
                       threshold=-250.0, sigma_vox=1.0):
    """Build the jittable fused preprocess step for fixed shapes.

    raw (B, Z, Y, X) stored values + per-series slope/intercept ->
    (volumes (B, oz, oy, ox) float32, masks uint8).

    The six contractions run at Precision.HIGHEST: under the GPU's
    default TF32 the Gaussian taps move the blurred volume by whole HU
    and flip threshold-mask voxels.
    """
    Z, Y, X = in_shape
    if ffs_op in ("ax_rot1", "ax_rot3"):
        ry, rx = X, Y
    else:
        ry, rx = Y, X
    oz, oy, ox = out_shape
    mz = jnp.asarray(_interp_matrix(oz, Z, Z / oz))
    my = jnp.asarray(_interp_matrix(oy, ry, ry / oy))
    mx = jnp.asarray(_interp_matrix(ox, rx, rx / ox))
    gz = jnp.asarray(_gauss_kernel_matrix(oz, sigma_vox))
    gy = jnp.asarray(_gauss_kernel_matrix(oy, sigma_vox))
    gx = jnp.asarray(_gauss_kernel_matrix(ox, sigma_vox))

    def step(raw, slope, intercept):
        vol = raw.astype(jnp.float32) * slope[:, None, None, None] \
            + intercept[:, None, None, None]
        if ffs_op == "ax_rot1":
            vol = jnp.rot90(vol, 1, (2, 3))
        elif ffs_op == "ax_rot2":
            vol = jnp.rot90(vol, 2, (2, 3))
        elif ffs_op == "ax_rot3":
            vol = jnp.rot90(vol, 3, (2, 3))
        # separable resample fused with the rescale above
        hi = jax.lax.Precision.HIGHEST
        out = jnp.einsum("ij,bjyx->biyx", mz, vol, precision=hi,
                         preferred_element_type=jnp.float32)
        out = jnp.einsum("kj,bzjx->bzkx", my, out, precision=hi,
                         preferred_element_type=jnp.float32)
        out = jnp.einsum("lj,bzyj->bzyl", mx, out, precision=hi,
                         preferred_element_type=jnp.float32)
        blurred = jnp.einsum("ij,bjyx->biyx", gz, out, precision=hi,
                             preferred_element_type=jnp.float32)
        blurred = jnp.einsum("kj,bzjx->bzkx", gy, blurred, precision=hi,
                             preferred_element_type=jnp.float32)
        blurred = jnp.einsum("lj,bzyj->bzyl", gx, blurred, precision=hi,
                             preferred_element_type=jnp.float32)
        mask = (blurred > threshold).astype(jnp.uint8)
        return out, mask

    return step


def preprocess_batch(raw, slopes, intercepts, out_shape=(64, 256, 256),
                     ffs_op="none", mesh=None):
    """Host wrapper: run the fused preprocess over a batch, optionally
    sharded over a Mesh."""
    fn = make_preprocess_fn(raw.shape[1:], out_shape, ffs_op=ffs_op)
    if mesh is None:
        return jax.jit(fn)(jnp.asarray(raw), jnp.asarray(slopes),
                           jnp.asarray(intercepts))
    from .mesh import batch_sharding, volume_sharding
    vs, bs = volume_sharding(mesh), batch_sharding(mesh)
    jfn = jax.jit(fn, in_shardings=(vs, bs, bs), out_shardings=(vs, vs))
    # host arrays go straight to their shards: jnp.asarray would first
    # stage the whole cohort on one device
    return jfn(jax.device_put(np.asarray(raw), vs),
               jax.device_put(np.asarray(slopes, np.float32), bs),
               jax.device_put(np.asarray(intercepts, np.float32), bs))


def demons_batch(fixed_batch, moving_batch, spacing_xyz=(1.0, 1.0, 1.0),
                 method="fast", iterations=30, std=1.0, step=2.0,
                 intensity_threshold=0.001, smooth=True, mesh=None,
                 forces="ssd", lncc_radius=3):
    """Deformable registration over a whole cohort: one compiled
    program runs B pairs back-to-back (``lax.map``, which keeps one
    pair's iteration state live at a time). With a Mesh, shard_map
    splits the pair axis over 'data' FIRST, so each device lax.maps
    only its local pairs (a bare lax.map under jit is a sequential loop
    GSPMD cannot partition). Returns (B, Z, Y, X, 3) DVFs in mm.

    method='syn' maps the SyN half-field evolution per pair, then
    assembles each u2 o u1^{-1} on host through invert_dvf/compose_dvf
    (same contract as demons_registration)."""
    from ..ops.registration.demons import _demons_core, _syn_core

    if forces not in ("ssd", "lncc"):
        raise ValueError(f"demons_batch: forces must be 'ssd' or "
                         f"'lncc', got {forces!r}")
    method = str(method).lower()
    if method not in ("demons", "fast", "diffeomorphic",
                      "biomechanical", "syn"):
        raise ValueError(f"demons_batch: unknown method {method!r}")
    fixed = jnp.asarray(fixed_batch, jnp.float32)
    moving = jnp.asarray(moving_batch, jnp.float32)
    sp = jnp.asarray(spacing_xyz, jnp.float32)

    def single(args):
        f, m = args
        if method == "syn":
            u1, u2 = _syn_core(
                f, m, sp, float(std), jnp.float32(step),
                jnp.float32(intensity_threshold), int(iterations),
                bool(smooth), forces, int(lncc_radius))
            # stack the halves on a leading axis so the map result
            # stays a single array per pair
            return jnp.stack([u1, u2])
        return _demons_core(f, m, sp, float(std), jnp.float32(step),
                            jnp.float32(intensity_threshold),
                            int(iterations), method, bool(smooth),
                            forces=forces, lncc_radius=int(lncc_radius))

    def fn(f, m):
        return jax.lax.map(single, (f, m))
    if mesh is None:
        jfn = jax.jit(fn)
    else:
        from jax.sharding import PartitionSpec as P

        spec = P("data")
        # check_vma=False: the single-pair cores start their loop
        # carries from constants (zero fields), which the varying-axes
        # check rejects inside a 'data'-manual body
        jfn = jax.jit(jax.shard_map(fn, mesh=mesh, in_specs=(spec, spec),
                                    out_specs=spec, check_vma=False))
    dvfs = jfn(fixed, moving)
    if method == "syn":
        from ..ops.registration.dvf import compose_dvf, invert_dvf
        halves = np.asarray(dvfs)            # (B, 2, Z, Y, X, 3) mm
        sp_np = np.asarray(spacing_xyz, np.float32)
        return np.stack([
            compose_dvf(halves[b, 1], invert_dvf(halves[b, 0], sp_np),
                        sp_np)
            for b in range(halves.shape[0])])
    return dvfs


def make_registration_step(vol_shape, lr=0.05, stride=2):
    """Batched 6-DoF intensity-registration train step.

    State: poses (B, 6) [scaled units], adam moments. Volumes
    (B, Z, Y, X): `ref`, `mov` share the grid (unit spacing, zero
    origin) — the full physical-geometry path lives in
    models/rigid_intensity; this step is the scaling/multichip
    workhorse shape.
    """
    import optax

    from ..models.rigid_intensity import _POSE_SCALE, pose_to_matrix
    from ..ops.resample import _trilinear

    Z, Y, X = vol_shape
    zz = jnp.arange(0, Z, stride, dtype=jnp.float32)
    yy = jnp.arange(0, Y, stride, dtype=jnp.float32)
    xx = jnp.arange(0, X, stride, dtype=jnp.float32)
    Zg, Yg, Xg = jnp.meshgrid(zz, yy, xx, indexing="ij")
    coords = jnp.stack([Xg.ravel(), Yg.ravel(), Zg.ravel()], axis=-1)
    ones = jnp.ones((coords.shape[0], 1), jnp.float32)
    coords_h = jnp.concatenate([coords, ones], axis=1)
    center = jnp.asarray([X / 2, Y / 2, Z / 2], jnp.float32)
    scale = jnp.asarray(_POSE_SCALE)
    opt = optax.adam(lr)

    def single_loss(params, ref, mov):
        m = pose_to_matrix(params * scale, center)
        mov_pix = jnp.matmul(coords_h, m.T,
                             precision=jax.lax.Precision.HIGHEST)
        ref_vals = _trilinear(ref, coords, jnp.float32(0.0))
        vals = _trilinear(mov, mov_pix[:, :3], jnp.float32(0.0))
        return jnp.mean((vals - ref_vals) ** 2)

    def loss_fn(params, refs, movs):
        losses = jax.vmap(single_loss)(params, refs, movs)
        return jnp.mean(losses)

    def train_step(params, opt_state, refs, movs):
        loss, g = jax.value_and_grad(loss_fn)(params, refs, movs)
        updates, opt_state = opt.update(g, opt_state)
        params = optax.apply_updates(params, updates)
        return params, opt_state, loss

    def init(batch):
        params = jnp.zeros((batch, 6), jnp.float32)
        return params, opt.init(params)

    return train_step, init


def compare_masks_batch(masks_a, masks_b, spacing, tolerance_mm=2.0,
                        mesh=None):
    """Cohort-scale segmentation QA: the full Dice/HD95/ASSD/
    surface-Dice panel for B mask pairs in ONE compiled program,
    optionally sharded over the mesh's 'data' axis (each chip runs its
    local pairs; a plain vmap batches the EDT min-plus passes).

    masks_a/masks_b: (B, Z, Y, X) bool/uint8; spacing [sx, sy, sz] mm
    (shared across the batch — resample first if grids differ).
    Returns a dict of (B,) float32 numpy arrays with the same keys as
    ops.edt.surface_metrics. With ``mesh``, B must be divisible by the
    'data' axis size.
    """
    from functools import partial


    from ..ops.edt import _surface_metrics_jit

    # stay host-side: jnp.asarray would stage the whole cohort on one
    # device before the sharded program reshards it (review finding —
    # same rule as the z-sharded halo entry points)
    a = np.asarray(masks_a)
    b = np.asarray(masks_b)
    if a.shape != b.shape or a.ndim != 4:
        raise ValueError("compare_masks_batch: expected matching "
                         f"(B, Z, Y, X) stacks, got {a.shape} vs {b.shape}")
    sp = tuple(float(v) for v in np.asarray(spacing).reshape(-1))
    single = partial(_surface_metrics_jit, spacing=sp,
                     tolerance_mm=float(tolerance_mm))
    fn = jax.vmap(single)
    if mesh is None:
        out = jax.jit(fn)(jnp.asarray(a), jnp.asarray(b))
    else:
        from .halo import _replicate
        out, multiproc = _data_sharded_call("compare_masks_batch",
                                            mesh, fn, [a, b])
        if multiproc:
            out = {k: _replicate(mesh, v) for k, v in out.items()}
    return {k: np.asarray(v) for k, v in out.items()}


def _data_sharded_call(name, mesh, fn, arrays):
    """Run a vmapped cohort kernel over the mesh's 'data' axis: batch
    divisibility check, shard_map, host->device sharded placement.
    Returns (out, multiproc); multi-process callers must _replicate
    outputs before np.asarray (see parallel/halo.py)."""
    from jax.sharding import PartitionSpec as P

    from .halo import _put_sharded
    n_data = mesh.shape["data"]
    B = arrays[0].shape[0]
    if B % n_data:
        raise ValueError(f"{name}: batch {B} not divisible by the "
                         f"'data' axis ({n_data})")
    spec = P("data")
    # check_vma=False: the vmapped single-pair cores (gamma scan,
    # rasterizer XOR scan) start loop carries from constants, which the
    # varying-axes check rejects inside a 'data'-manual body
    jfn = jax.jit(jax.shard_map(fn, mesh=mesh,
                                in_specs=(spec,) * len(arrays),
                                out_specs=spec, check_vma=False))
    vs, multiproc = _put_sharded(mesh, [(a, spec) for a in arrays])
    return jfn(*vs), multiproc


def dvh_batch(doses, masks, voxel_volume_cc, max_dose=150, increment=5,
              mesh=None):
    """Cohort-scale DVH: the full Dmin/Dmax/Dmean/Dmedian/Dstd +
    D1..D99 + VS{d}Gy panel for B (dose grid, ROI mask) pairs in ONE
    compiled program, optionally sharded over the mesh's 'data' axis.
    The single-pair path extracts dose[mask] on host and pads to a
    bucket (ops/dvh.dvh_statistics); here the mask IS the kernel's
    validity input, so nothing leaves the device until the (B,)
    reductions come back.

    doses/masks: (B, Z, Y, X), aligned grids (resample each dose onto
    its image grid first — Dose.compute_roi_dose_array semantics);
    voxel_volume_cc: scalar or (B,) when spacings differ. Returns a
    dict of numpy arrays keyed like dvh_statistics: 'Volume (cc)',
    'Dmin', ..., 'D{p}' per D_VALUES, 'VS{d}Gy_percent'/'VS{d}Gy_cc'.
    Pairs with an empty mask come back NaN (volume 0), matching the
    host path's early-out. With ``mesh``, B must divide by 'data'.
    """

    from ..ops.dvh import D_VALUES, _dvh_core

    d = np.asarray(doses, np.float32)
    m = np.asarray(masks)
    if d.shape != m.shape or d.ndim != 4:
        raise ValueError("dvh_batch: expected matching (B, Z, Y, X) "
                         f"stacks, got {d.shape} vs {m.shape}")
    B = d.shape[0]
    vox = np.broadcast_to(np.asarray(voxel_volume_cc, np.float32), (B,))
    n_bins = int(max_dose // increment + 2)
    d_pcts = jnp.asarray(np.asarray(D_VALUES, np.float32))

    def single(dose_vol, mask_vol):
        return _dvh_core(dose_vol.ravel(), mask_vol.ravel() > 0,
                         d_pcts, n_bins, float(increment))

    fn = jax.vmap(single)
    if mesh is None:
        out = jax.jit(fn)(jnp.asarray(d), jnp.asarray(m))
    else:
        from .halo import _replicate
        out, multiproc = _data_sharded_call("dvh_batch", mesh, fn,
                                            [d, m])
        if multiproc:
            out = tuple(_replicate(mesh, v) for v in out)
    dmin, dmax, mean, median, std, d_out, below, count = \
        (np.asarray(v).astype(np.float64) for v in out)
    empty = count == 0
    for stat in (dmin, dmax, mean, median, std, d_out):
        stat[empty] = np.nan  # kernel pads would leak +-3.4e38 here
    res = {"Volume (cc)": count * vox,
           "Dmin": dmin, "Dmax": dmax, "Dmean": mean,
           "Dmedian": median, "Dstd": std}
    for i, p in enumerate(D_VALUES):
        res[f"D{p}"] = d_out[:, i]
    with np.errstate(invalid="ignore", divide="ignore"):
        for i in range(n_bins):
            g = i * increment
            if g > max_dose + increment:
                break
            res[f"VS{g}Gy_percent"] = below[:, i] / count * 100.0
            res[f"VS{g}Gy_cc"] = below[:, i] * vox
    return res


def gamma_batch(ref_doses, eval_doses, spacing, dose_pct=3.0,
                dta_mm=3.0, local=False, threshold_pct=10.0,
                subdiv=None, cap=2.0, mesh=None, return_maps=False):
    """Cohort gamma-index QA: B (reference, evaluated) dose pairs on a
    SHARED grid — the accumulated / recomputed dose-QA case (cross-grid
    pairs: resample first, or run Dose.compute_gamma per pair) — in one
    compiled program, optionally sharded over the 'data' mesh axis.

    Same TG-218 sub-voxel search as ops.gamma.gamma_index (one
    fine-grid upsample + phase-decomposed offset scan per pair, exact
    up to ``cap``); per-pair normalisation is max(ref). Returns a dict
    of (B,) numpy arrays: pass_rate, mean, max, analysed_voxels,
    norm_dose (+ 'gamma' (B, Z, Y, X) maps when ``return_maps``).
    All-zero reference grids report pass_rate 100 with 0 analysed
    voxels (the per-pair path raises instead).
    """

    from ..ops.gamma import (_decompose_offsets, _gamma_fn,
                             fine_grid_layout, upsample_to_fine)

    ref = np.asarray(ref_doses, np.float32)
    ev = np.asarray(eval_doses, np.float32)
    if ref.shape != ev.shape or ref.ndim != 4:
        raise ValueError("gamma_batch: expected matching (B, Z, Y, X) "
                         f"stacks, got {ref.shape} vs {ev.shape}")
    if cap < 1.0:
        raise ValueError(f"gamma_batch: cap must be >= 1, got {cap}")
    B = ref.shape[0]
    s, r, offsets, dist2 = fine_grid_layout(spacing, dta_mm, subdiv, cap)
    rows = jnp.asarray(_decompose_offsets(offsets, s, r))
    dist2_j = jnp.asarray(dist2, jnp.float32)
    run = _gamma_fn(ref.shape[1:], s, r, None)
    dta2 = jnp.float32(dta_mm * dta_mm)
    pct = jnp.float32(dose_pct / 100.0)
    thr = jnp.float32(threshold_pct / 100.0)
    capf = jnp.float32(cap)

    def single(ref_v, ev_v):
        norm = jnp.max(ref_v)
        norm_safe = jnp.maximum(norm, jnp.float32(1e-6))
        if local:
            dd = pct * jnp.maximum(jnp.abs(ref_v), 1e-6 * norm_safe)
            dd2 = dd * dd
        else:
            dd2 = (pct * norm_safe) ** 2
        fine = upsample_to_fine(ev_v, s, r)
        gam = jnp.minimum(run(ref_v, fine, dd2, rows, dist2_j, dta2),
                          capf)
        mask = (ref_v >= thr * norm) & (norm > 0)
        n = jnp.sum(mask)
        nf = jnp.maximum(n, 1).astype(jnp.float32)
        stats = {
            "pass_rate": jnp.where(
                n > 0,
                jnp.sum(jnp.where(mask, gam <= 1.0, False)) / nf * 100.0,
                100.0),
            "mean": jnp.sum(jnp.where(mask, gam, 0.0)) / nf,
            "max": jnp.max(jnp.where(mask, gam, 0.0)),
            # int32, not f32: exact counts above 2^24 voxels (the
            # per-pair gamma_index path reports an exact int)
            "analysed_voxels": n.astype(jnp.int32),
            "norm_dose": norm,
        }
        return (stats, gam) if return_maps else (stats, jnp.float32(0))

    fn = jax.vmap(single)
    if mesh is None:
        stats, maps = jax.jit(fn)(jnp.asarray(ref), jnp.asarray(ev))
    else:
        from .halo import _replicate
        (stats, maps), multiproc = _data_sharded_call(
            "gamma_batch", mesh, fn, [ref, ev])
        if multiproc:
            stats = {k: _replicate(mesh, v) for k, v in stats.items()}
            if return_maps:
                maps = _replicate(mesh, maps)
    out = {k: np.asarray(v) for k, v in stats.items()}
    out["subdiv"] = s
    out["search_offsets"] = int(len(dist2))
    if return_maps:
        out["gamma"] = np.asarray(maps)
    return out


def radiomics_batch(volumes, masks, spacing, bin_width=None, n_bins=32,
                    alpha=0, families=None, mesh=None):
    """Cohort radiomics: the texture-matrix counting for B (volume,
    ROI) pairs — the heavy part of a radiomics run — in ONE compiled
    program (vmapped one-hot matmul counting, ops/radiomics.py),
    optionally sharded over the mesh's 'data' axis. The tiny per-pair
    matrices come back to host where the feature formulas (and the
    inherently-host shape/GLSZM families) evaluate per pair.

    volumes/masks: (B, Z, Y, X) pairs pre-cropped to a SHARED bounding
    shape (pad masks with False; per-pair discretization happens here
    so intensity ranges may differ). Returns a list of B dicts with
    the exact ``ops.radiomics.compute_radiomics`` schema. With
    ``mesh``, B must divide by 'data'.
    """

    from ..ops import radiomics as rad

    vols = np.asarray(volumes, np.float32)
    ms = np.asarray(masks) > 0
    if vols.shape != ms.shape or vols.ndim != 4:
        raise ValueError("radiomics_batch: expected matching "
                         f"(B, Z, Y, X) stacks, got {vols.shape} vs "
                         f"{ms.shape}")
    if families is None:
        families = rad.ALL_FAMILIES
    B = vols.shape[0]
    sp = np.asarray(spacing, np.float64).reshape(-1)

    levels = np.zeros(vols.shape, np.int32)
    ngs = []
    for b in range(B):
        if bin_width is not None:
            levels[b], ng = rad.discretize(vols[b], ms[b],
                                           bin_width=bin_width)
        else:
            levels[b], ng = rad.discretize(vols[b], ms[b],
                                           n_bins=n_bins)
        ngs.append(ng)
    ng_max = max(ngs)
    lmax = max(vols.shape[1:])

    need_tex = any(f in families for f in
                   ("glcm", "glrlm", "gldm", "ngtdm", "firstorder"))
    mats = None
    if need_tex:
        def single(lev, valid):
            return rad._texture_matrices_jit(lev, valid, ng_max, lmax,
                                             int(alpha))

        fn = jax.vmap(single)
        if mesh is None:
            mats = jax.jit(fn)(jnp.asarray(levels), jnp.asarray(ms))
        else:
            from .halo import _replicate
            mats, multiproc = _data_sharded_call(
                "radiomics_batch", mesh, fn, [levels, ms])
            if multiproc:
                mats = {k: _replicate(mesh, v) for k, v in mats.items()}
        mats = {k: np.asarray(v, np.float64) for k, v in mats.items()}

    out = []
    for b in range(B):
        ng = ngs[b]  # formulas see the pair's OWN level count: Ng
        # appears directly in Idn/Idmn, and zero-padded rows would
        # shift nothing else (zero counts)
        res = {}
        n_vox = int(ms[b].sum())
        if "firstorder" in families:
            res["firstorder"] = rad.first_order_features(
                vols[b], ms[b], sp,
                hist=None if mats is None else mats["hist"][b][:ng])
        if "shape" in families:
            res["shape"] = rad.shape_features(ms[b], sp)
        if "glcm" in families:
            res["glcm"] = rad.glcm_features(
                mats["glcm"][b][:, :ng, :ng])
        if "glrlm" in families:
            res["glrlm"] = rad.glrlm_features(
                mats["glrlm"][b][:, :ng, :], n_vox)
        if "glszm" in families:
            res["glszm"] = rad.glszm_features(
                rad.glszm_matrix(levels[b], ms[b], ng), n_vox)
        if "gldm" in families:
            res["gldm"] = rad.gldm_features(mats["gldm"][b][:ng],
                                            n_vox)
        if "ngtdm" in families:
            res["ngtdm"] = rad.ngtdm_features(mats["ngtdm_s"][b][:ng],
                                              mats["ngtdm_n"][b][:ng])
        res["meta"] = {"Ng": ng, "voxels": n_vox,
                       "bin_width": bin_width,
                       "n_bins": (None if bin_width is not None
                                  else n_bins)}
        out.append(res)
    return out


def n4_batch(volumes, masks=None, shrink=4, n_bins=200, fwhm=0.15,
             noise=0.01, levels=4, max_iterations=50,
             conv_threshold=1e-3, min_control_spacing=32.0,
             return_fields=False, mesh=None):
    """Cohort N4 bias correction: all fitting levels for B volumes in
    ONE compiled program (vmapped ``ops.n4._n4_level`` — the loop body
    gates on each lane's own convergence statistic, so per-lane
    trajectories match the single-volume path even though the batched
    while_loop runs until the slowest lane converges), optionally
    sharded over the mesh's 'data' axis. The MR-standardization
    front-end for cohort registration / radiomics.

    volumes: (B, Z, Y, X) positive intensities (shared shape); masks:
    optional (B, Z, Y, X) fit regions. Returns corrected (B, Z, Y, X)
    float32 (plus the multiplicative fields when ``return_fields``).
    With ``mesh``, B must divide by 'data'. Other knobs as
    :func:`medicalimageanalysis_tpu.ops.n4.n4_bias_correction`.
    """

    from ..ops import n4 as _n4

    vols = np.asarray(volumes, np.float32)
    if vols.ndim != 4:
        raise ValueError(f"n4_batch: expected (B, Z, Y, X), got "
                         f"{vols.shape}")
    m = (np.ones(vols.shape, bool) if masks is None
         else np.asarray(masks) > 0)
    if m.shape != vols.shape:
        raise ValueError(f"n4_batch: masks shape {m.shape} != "
                         f"volumes shape {vols.shape}")
    m = m & (vols > 0)
    shrink = max(1, int(shrink))
    sv = vols[:, ::shrink, ::shrink, ::shrink]
    sm = m[:, ::shrink, ::shrink, ::shrink]
    logv = np.where(sm, np.log(np.maximum(sv, 1e-30)), 0.0)
    w = sm.astype(np.float32)
    shape3 = sv.shape[1:]
    mats_per_level = [
        _n4._level_basis_mats(shape3, sp) for sp in
        _n4._level_spacings(shape3, levels, min_control_spacing,
                            shrink)]

    def lane(res, wl):
        total = jnp.zeros_like(res)
        for mats in mats_per_level:
            res, total = _n4._n4_level(
                res, total, wl, n_bins, float(fwhm), float(noise),
                float(conv_threshold), int(max_iterations), *mats)
        return total

    fn = jax.vmap(lane)
    arrays = [logv.astype(np.float32), w]
    if mesh is None:
        total = jax.jit(fn)(*[jnp.asarray(a) for a in arrays])
    else:
        from .halo import _replicate
        total, multiproc = _data_sharded_call("n4_batch", mesh, fn,
                                              arrays)
        if multiproc:
            total = _replicate(mesh, total)

    if _n4._finalize_on_device():
        fin = jax.vmap(_n4._n4_finalize, in_axes=(0, 0, None))
        corrected, fields = fin(jnp.asarray(vols), total, shrink)
        corrected = np.asarray(corrected)
        fields = np.asarray(fields) if return_fields else None
    else:
        lt = np.asarray(total)
        lanes = [_n4._host_finalize(vols[b], lt[b], shrink,
                                    return_fields)
                 for b in range(vols.shape[0])]
        corrected = np.stack([c for c, _ in lanes])
        fields = (np.stack([f for _, f in lanes]) if return_fields
                  else None)
    if return_fields:
        return corrected, fields
    return corrected


def rasterize_batch(contour_sets, dimensions, plane="Axial", mesh=None):
    """Cohort contour rasterization: ALL contours of ALL ROIs (across
    a whole structure set or patient cohort) in one sharded device
    pass — the batch twin of the per-ROI XOR rasterizer (reference
    cv2.fillPoly loop, utils/convert/contour.py:76-116).

    contour_sets: list over B ROIs; each entry a list of (N, 3) pixel
    contours (any plane-consistent mix of slices). dimensions:
    (Z, Y, X) of the SHARED grid; plane: slicing plane of the
    contours. Returns (B, Z, Y, X) uint8 masks with per-slice XOR
    semantics, bit-parity with the cv2 backend.

    Without ``mesh``: the single-chip fast path — polygons of every
    ROI pool into ONE canvas program per bbox-tile class
    (ops.rasterize.rasterize_polygons_grouped). With ``mesh``: ROIs
    shard over the 'data' axis (B divisible by it; each lane runs the
    full-frame kernel on its padded polygons — the multi-chip scaling
    path, value-identical to the pooled one).
    """

    from ..ops.rasterize import (_bucket, _polygon_bitmaps,
                                 _scatter_xor, stage_polygons,
                                 rasterize_polygons_grouped)
    from ..utils.convert.contour import _plane_split

    d0, d1, d2 = (int(d) for d in dimensions[:3])
    if plane == "Axial":
        S, H, W, axis = d0, d1, d2, 0
    elif plane == "Coronal":
        S, H, W, axis = d1, d0, d2, 1
    else:
        S, H, W, axis = d2, d0, d1, 2

    grouped = [_plane_split(cs, plane) for cs in contour_sets]
    B = len(grouped)

    if mesh is None:
        out = rasterize_polygons_grouped(grouped, S, H, W)
    else:
        # per-ROI padded pools, lanes sharded over 'data'
        Kmax = _bucket(max((len(p) for p, _ in grouped if p),
                           default=1), minimum=1)
        E = _bucket(max((c.shape[0] for p, _ in grouped for c in p),
                        default=8))
        verts = np.zeros((B, Kmax, E + 1, 2), np.int32)
        valid = np.zeros((B, Kmax, E), bool)
        rows = np.full((B, Kmax), S, np.int32)
        for b, (polys, sids) in enumerate(grouped):
            verts[b], valid[b] = stage_polygons(polys, E, Kmax)
            for k, s in enumerate(np.asarray(sids, np.int64)):
                rows[b, k] = s if 0 <= s < S else S

        def single(v, ev, r):
            return _scatter_xor(_polygon_bitmaps(v, ev, H, W), r, S)

        fn = jax.vmap(single)
        from .halo import _replicate
        out, multiproc = _data_sharded_call("rasterize_batch", mesh,
                                            fn, [verts, valid, rows])
        if multiproc:
            out = _replicate(mesh, out)
        out = np.asarray(out)

    if axis == 1:
        out = np.moveaxis(out, 1, 2)
    elif axis == 2:
        out = np.moveaxis(out, 1, 3)
    return (out > 0).astype(np.uint8)
