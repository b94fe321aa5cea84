"""Drive the library's main path once on one GPU, at clinical size, and
check every phase against a plain numpy/scipy reference.

Phases (all through the public API):

1. ingest       4 synthetic CT series of 128 x 512 x 512 int16 written
                with CreateDicomImage, read back with mia.read_dicoms;
                arrays must match exactly, geometry to 1e-6.
2. preprocess   the fused device preprocess (rescale -> FFS -> resample
                to 128 x 256 x 256 -> Gaussian -> threshold mask) against
                a float64 numpy twin.
3. structures   an RTSTRUCT of 8 ROIs written with Image.create_rtstruct,
                re-read, Roi.compute_mask on the device rasterizer,
                compared bit for bit with a numpy scanline twin.
4. rigid        series 2 is series 1 under a known rigid transform
                (3 degrees, 4 mm); Rigid.compute_intensity recovers it
                and create_image matches scipy map_coordinates(order=1)
                (sample points within 1e-3 voxel of the volume boundary
                are excluded: float32 and float64 may disagree there on
                inside vs background).
5. deformable   Deformable.compute_demons at 128 x 256 x 256 against a
                smooth known field, create_image against map_coordinates,
                then Dose.compute_dvh_curve on an RTDOSE written with
                Dose.create_rtdose against numpy counts.

Every phase prints its wall time, error, tolerance and matmul precision.
The last line of standard output is one JSON object naming the device.

Run:   python chip_smoke.py            one GPU, the phases above
       python chip_smoke.py --multi    four GPUs: the ('data', 'space')
                                       mesh paths, each against its
                                       one-device result
       python chip_smoke.py --tiny     tiny shapes on any backend (a CPU
                                       rehearsal; prints no device line)

Exits non-zero when a phase fails or when JAX finds no GPU.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))

FULL = dict(n_series=4, ct_shape=(128, 512, 512), pre_out=(128, 256, 256),
            demons_shape=(128, 256, 256), demons_iters=50,
            multi_reg_shape=(64, 128, 128), multi_demons_iters=20)
TINY = dict(n_series=4, ct_shape=(8, 48, 48), pre_out=(8, 24, 24),
            demons_shape=(16, 32, 32), demons_iters=30,
            multi_reg_shape=(8, 16, 16), multi_demons_iters=4)

SPACING = (0.9765625, 0.9765625)          # in-plane [sx, sy] mm
THICKNESS = 2.5                           # mm
THRESHOLD = -250.0                        # external mask threshold, HU
BACKGROUND = -3001.0                      # reslice fill, HU
N_ROIS = 8
HIGHEST = "float32 (Precision.HIGHEST pinned)"
GATHER = "float32 (no matmul)"


# ---------------------------------------------------------------------
# numpy references (no library code)
# ---------------------------------------------------------------------
def ref_lerp_axis(vol, axis, n_out):
    """Linear resample along one axis at positions i * n_in / n_out,
    clamped to the last sample (float64)."""
    n_in = vol.shape[axis]
    src = np.minimum(np.arange(n_out, dtype=np.float64) * (n_in / n_out),
                     n_in - 1)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, n_in - 1)
    shape = [1] * vol.ndim
    shape[axis] = n_out
    f = (src - lo).reshape(shape)
    return (np.take(vol, lo, axis=axis) * (1.0 - f)
            + np.take(vol, hi, axis=axis) * f)


def ref_gauss_axis(vol, axis, sigma):
    """Gaussian along one axis: taps to 4 sigma (at least 1),
    normalized, edge-replicated (float64)."""
    r = max(1, int(np.ceil(4 * sigma)))
    offs = np.arange(-r, r + 1)
    taps = np.exp(-0.5 * (offs / sigma) ** 2)
    taps /= taps.sum()
    n = vol.shape[axis]
    out = np.zeros(vol.shape, np.float64)
    for o, w in zip(offs, taps):
        idx = np.clip(np.arange(n) + o, 0, n - 1)
        out += w * np.take(vol, idx, axis=axis)
    return out


def ref_preprocess(raw, slope, intercept, out_shape, rot_k, sigma):
    """rescale -> rot90 in-plane -> trilinear resample -> Gaussian.
    Returns (resampled, blurred), float64, for one (Z, Y, X) series."""
    vol = raw.astype(np.float64) * slope + intercept
    vol = np.rot90(vol, rot_k, axes=(1, 2))
    for ax in range(3):
        vol = ref_lerp_axis(vol, ax, out_shape[ax])
    blurred = vol
    for ax in range(3):
        blurred = ref_gauss_axis(blurred, ax, sigma)
    return vol, blurred


def _ref_polygon(poly, H, W):
    """One closed polygon (integer vertices) -> (H, W) bool: even-odd
    interior (pixel px is inside a crossing at x when px < ceil(x)) or
    the 8-connected boundary run (shallow edges cover the pixels whose
    centre row y(x) lies in (py - 0.5, py + 0.5], open at the run's low
    end; steep edges cover round-half-down x(py) on every row they
    span)."""
    eps = 1e-3
    p = np.asarray(poly, np.float64)
    x1, y1 = p[:, 0], p[:, 1]
    x2, y2 = np.roll(x1, -1), np.roll(y1, -1)
    out = np.zeros((H, W), bool)
    r0 = int(max(0, min(y1.min(), H - 1)))
    r1 = int(max(0, min(y1.max(), H - 1)))
    rows = np.arange(r0, r1 + 1, dtype=np.float64)[:, None]     # (R, 1)
    dx, dy = x2 - x1, y2 - y1
    sdy = np.where(dy != 0, dy, 1.0)

    # interior: parity of the crossings to the right of each pixel
    crosses = (y1 > rows) != (y2 > rows)
    x_int = x1 + (rows - y1) * dx / sdy
    bins = np.clip(np.ceil(x_int), 0, W).astype(np.int64)
    hist = np.zeros((rows.shape[0], W + 2), np.int64)
    ri, ei = np.nonzero(crosses)
    np.add.at(hist, (ri, bins[ri, ei]), 1)
    right = np.cumsum(hist[:, ::-1], axis=1)[:, ::-1]   # crossings >= b
    inside = (right[:, 1:W + 1] % 2).astype(bool)       # bins > px

    # boundary runs
    shallow = np.abs(dx) >= np.abs(dy)
    t_m = x1 + (rows - 0.5 - y1) * dx / sdy
    t_p = x1 + (rows + 0.5 - y1) * dx / sdy
    lo_sl = np.ceil(np.minimum(t_m, t_p) + eps)
    hi_sl = np.floor(np.maximum(t_m, t_p) + eps)
    flat_row = np.abs(rows - y1) < 0.5
    lo_sh = np.where(dy != 0, lo_sl, np.where(flat_row, -np.inf, np.inf))
    hi_sh = np.where(dy != 0, hi_sl, np.where(flat_row, np.inf, -np.inf))
    lo_sh = np.maximum(lo_sh, np.minimum(x1, x2))
    hi_sh = np.minimum(hi_sh, np.maximum(x1, x2))
    xs = np.floor(x1 + (rows - y1) * dx / sdy + 0.5 - eps)
    on_rows = (rows >= np.minimum(y1, y2)) & (rows <= np.maximum(y1, y2))
    lo = np.where(shallow, lo_sh, np.where(on_rows, xs, 1.0))
    hi = np.where(shallow, hi_sh, np.where(on_rows, xs, 0.0))
    ok = (hi >= lo) & (hi >= 0) & (lo <= W - 1)
    diff = np.zeros((rows.shape[0], W + 2), np.int64)
    ri, ei = np.nonzero(ok)
    np.add.at(diff, (ri, np.clip(lo[ri, ei], 0, W).astype(np.int64)), 1)
    np.add.at(diff, (ri, np.clip(hi[ri, ei] + 1, 0, W + 1)
                     .astype(np.int64)), -1)
    border = np.cumsum(diff, axis=1)[:, :W] > 0
    out[r0:r1 + 1] = inside | border
    return out


def ref_rasterize(contour_pixel, shape):
    """Axial pixel contours (N, 3) -> (Z, Y, X) uint8: vertices
    truncated as trunc(v + 1e-6), one bitmap per polygon, XOR per
    slice, out-of-volume slices dropped."""
    Z, H, W = shape
    acc = np.zeros(shape, np.uint8)
    for c in contour_pixel:
        c = np.asarray(c, np.float64)
        s = int(np.round(c[0, 2]))
        if not 0 <= s < Z:
            continue
        v = np.trunc(c[:, :2] + 1e-6)
        acc[s] ^= _ref_polygon(v, H, W).astype(np.uint8)
    return acc


def ref_trilinear(vol, coords_zyx, background):
    """scipy map_coordinates(order=1) inside the volume, background
    outside [0, dim - 1] on any axis."""
    from scipy.ndimage import map_coordinates
    out = map_coordinates(np.asarray(vol, np.float64), coords_zyx,
                          order=1, mode="nearest")
    inside = np.ones(out.shape, bool)
    for ax, n in enumerate(vol.shape):
        inside &= (coords_zyx[ax] >= 0) & (coords_zyx[ax] <= n - 1)
    return np.where(inside, out, background)


def edge_band(coords_zyx, shape, band=1e-3):
    """Voxels whose sample point lies within `band` voxels of the volume
    boundary on some axis: float32 and float64 coordinates may put them
    on opposite sides of the inside test (value vs background)."""
    amb = np.zeros(coords_zyx.shape[1:], bool)
    for ax, n in enumerate(shape):
        c = coords_zyx[ax]
        amb |= (np.abs(c) < band) | (np.abs(c - (n - 1)) < band)
    return amb


def ref_below_counts(values, bins):
    """Cumulative DVH counts in float32, as stored: #(value < bin)."""
    v = np.sort(np.asarray(values, np.float32))
    return np.searchsorted(v, np.asarray(bins, np.float32), side="left")


# ---------------------------------------------------------------------
# synthetic data
# ---------------------------------------------------------------------
def make_phantom(shape, rng):
    """Smooth CT-like float32 volume in HU: air, body, lungs, spine."""
    from scipy.ndimage import gaussian_filter
    Z, Y, X = shape
    zz = np.linspace(-1, 1, Z, dtype=np.float32)[:, None, None]
    yy = np.linspace(-1, 1, Y, dtype=np.float32)[None, :, None]
    xx = np.linspace(-1, 1, X, dtype=np.float32)[None, None, :]
    vol = np.full(shape, -1000.0, np.float32)
    body = (xx / 0.8) ** 2 + (yy / 0.6) ** 2 <= 1.0 - 0.1 * zz ** 2
    vol[np.broadcast_to(body, shape)] = 40.0
    for cx in (-0.35, 0.35):
        lung = ((xx - cx) / 0.25) ** 2 + ((yy + 0.05) / 0.35) ** 2 \
            + (zz / 1.3) ** 2 <= 1.0
        vol[np.broadcast_to(lung, shape)] = -820.0
    spine = (xx / 0.08) ** 2 + ((yy - 0.42) / 0.08) ** 2 <= 1.0
    vol[np.broadcast_to(spine, shape)] = 700.0
    vol = gaussian_filter(vol, sigma=(1.0, 1.5, 1.5))
    vol += rng.normal(0.0, 8.0, shape).astype(np.float32)
    return vol


def pixel_to_position(origin, spacing_xyz):
    """Identity-direction grid: (x, y, z, 1) pixel -> mm."""
    m = np.diag(list(spacing_xyz) + [1.0])
    m[:3, 3] = origin
    return m


def rigid_transform(deg_z, t_mm, center):
    """4x4 rotation about z by deg_z around `center`, then t_mm."""
    a = np.deg2rad(deg_z)
    R = np.array([[np.cos(a), -np.sin(a), 0.0],
                  [np.sin(a), np.cos(a), 0.0], [0.0, 0.0, 1.0]])
    T = np.eye(4)
    T[:3, :3] = R
    T[:3, 3] = center - R @ center + np.asarray(t_mm)
    return T


def warp_by_physical(vol, origin, spacing_xyz, M, background):
    """out(p) = vol(pix(M @ pos(p))) on the same identity grid."""
    Z, Y, X = vol.shape
    p2p = pixel_to_position(origin, spacing_xyz)
    A = np.linalg.inv(p2p) @ M @ p2p          # out pixel -> in pixel
    zz, yy, xx = np.meshgrid(np.arange(Z), np.arange(Y), np.arange(X),
                             indexing="ij")
    pix = np.stack([xx, yy, zz, np.ones_like(xx)]).reshape(4, -1)
    src = A @ pix
    coords = np.stack([src[2], src[1], src[0]]).reshape(3, Z, Y, X)
    return ref_trilinear(vol, coords, background)


def _rel_err(got, ref, keep):
    """max |got - ref| / max |ref| over the voxels in `keep`, and a note
    locating the worst voxel."""
    d = np.where(keep, np.abs(np.asarray(got, np.float64) - ref), 0.0)
    i = np.unravel_index(int(np.argmax(d)), d.shape)
    rel = float(d[i]) / max(float(np.max(np.abs(ref[keep]))), 1e-12)
    return rel, (f"worst voxel {tuple(int(v) for v in i)}: "
                 f"got {float(np.asarray(got)[i]):.6g} ref {ref[i]:.6g}")


class PhaseError(AssertionError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def report(name, t0, err, tol, precision, extra=""):
    line = (f"phase={name} wall_s={time.perf_counter() - t0:.3f} "
            f"max_err={err:.6g} tol={tol:.6g} precision={precision}")
    print(line + (f" {extra}" if extra else ""), flush=True)


# ---------------------------------------------------------------------
# single-GPU phases
# ---------------------------------------------------------------------
def phase_ingest(cfg, work, rng):
    import medicalimageanalysis_tpu as mia
    from medicalimageanalysis_tpu.data import Data
    from medicalimageanalysis_tpu.utils.creation import CreateDicomImage

    t0 = time.perf_counter()
    shape = cfg["ct_shape"]
    Z, Y, X = shape
    origin = np.array([-X * SPACING[0] / 2, -Y * SPACING[1] / 2,
                       -Z * THICKNESS / 2])
    spacing_xyz = (SPACING[0], SPACING[1], THICKNESS)
    base = make_phantom(shape, rng)
    center = origin + (np.array([X, Y, Z]) - 1) / 2 * spacing_xyz
    T = rigid_transform(3.0, np.array([1, -1, 1]) * 4.0 / np.sqrt(3),
                        center)
    arrays, series = [], []
    for s in range(cfg["n_series"]):
        if s == 1:
            # series 2 = series 1 seen through T: mov(T p) = base(p)
            vol = warp_by_physical(arrays[0], origin, spacing_xyz,
                                   np.linalg.inv(T), -1000.0)
        else:
            vol = base + rng.normal(0.0, 4.0, shape).astype(np.float32)
        arr = np.clip(np.round(vol), -1024, 3071).astype(np.int16)
        folder = os.path.join(work, f"series{s}")
        gen = CreateDicomImage(folder, arr, origin=list(origin),
                               spacing=list(SPACING), thickness=THICKNESS)
        gen.run(patient_id="SMOKE", description=f"smoke {s}")
        arrays.append(arr)
        series.append({"folder": folder, "uid": gen.series,
                       "files": [os.path.join(folder, f"{i}.dcm")
                                 for i in range(Z)]})
    t_write = time.perf_counter() - t0

    t0 = time.perf_counter()
    mia.read_dicoms(folder_path=work)
    by_uid = {Data.image[n].series_uid: n for n in Data.image_list}
    check(len(by_uid) == cfg["n_series"],
          f"ingest: {len(by_uid)} images for {cfg['n_series']} series")
    geo_err = 0.0
    for s, info in enumerate(series):
        img = Data.image[by_uid[info["uid"]]]
        info["name"] = by_uid[info["uid"]]
        got = np.asarray(img.array)
        check(got.shape == shape, f"ingest: shape {got.shape}")
        check(np.array_equal(got, arrays[s]),
              f"ingest: series {s} array differs from what was written")
        geo_err = max(geo_err,
                      float(np.abs(np.asarray(img.spacing)
                                   - spacing_xyz).max()),
                      float(np.abs(np.asarray(img.origin) - origin).max()),
                      float(np.abs(np.asarray(img.matrix)
                                   - np.eye(3)).max()))
    check(geo_err <= 1e-6, f"ingest: geometry error {geo_err}")
    report("ingest", t0, geo_err, 1e-6, "n/a (host parse)",
           f"series={cfg['n_series']} shape={list(shape)} "
           f"write_s={t_write:.3f} array_mismatch_voxels=0")
    return dict(arrays=arrays, series=series, origin=origin,
                spacing_xyz=spacing_xyz, T=T, center=center)


def phase_preprocess(cfg, state):
    import jax
    from medicalimageanalysis_tpu.data import Data
    from medicalimageanalysis_tpu.parallel.batch import make_preprocess_fn

    t0 = time.perf_counter()
    imgs = [Data.image[info["name"]] for info in state["series"]]
    raw = np.stack([np.asarray(im.array) for im in imgs])
    slope = np.ones(len(imgs), np.float32)
    intercept = np.zeros(len(imgs), np.float32)
    fn = jax.jit(make_preprocess_fn(cfg["ct_shape"], cfg["pre_out"],
                                    ffs_op="ax_rot2", threshold=THRESHOLD,
                                    sigma_vox=1.0))
    vols, masks = jax.block_until_ready(fn(raw, slope, intercept))
    t_dev = time.perf_counter() - t0
    vols, masks = np.asarray(vols), np.asarray(masks)
    check(vols.shape == (len(imgs),) + tuple(cfg["pre_out"]),
          f"preprocess: shape {vols.shape}")
    check(np.isfinite(vols).all(), "preprocess: non-finite volume")
    err, bad_mask = 0.0, 0
    for b in range(len(imgs)):
        ref_v, ref_b = ref_preprocess(raw[b], 1.0, 0.0, cfg["pre_out"],
                                      2, 1.0)
        err = max(err, float(np.abs(vols[b] - ref_v).max()))
        ref_m = ref_b > THRESHOLD
        near = np.abs(ref_b - THRESHOLD) <= 1e-2
        bad_mask += int(np.sum(((masks[b] > 0) != ref_m) & ~near))
    check(err <= 1e-2, f"preprocess: max |dHU| {err} > 1e-2")
    check(bad_mask == 0, f"preprocess: {bad_mask} mask voxels differ")
    report("preprocess", t0, err, 1e-2, HIGHEST,
           f"device_s={t_dev:.3f} mask_mismatch_voxels={bad_mask} "
           f"out={list(cfg['pre_out'])}")
    state["preprocessed"] = vols


def _roi_contours(shape, origin, k, rng):
    """A few axial contours (mm) for ROI k: a star- or ellipse-shaped
    polygon per slice over a band of slices; ROI 0 also carries an
    inner hole contour on the same slices (XOR)."""
    Z, Y, X = shape
    z0 = int(rng.integers(0, max(1, Z // 3)))
    z1 = min(Z, z0 + max(2, Z // 2))
    cx = X * (0.3 + 0.4 * rng.random())
    cy = Y * (0.3 + 0.4 * rng.random())
    r = min(X, Y) * (0.06 + 0.08 * rng.random())
    n = 24 + 8 * k
    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    star = 1.0 + (0.35 if k % 2 else 0.0) * np.cos(5 * th)
    out = []
    for z in range(z0, z1):
        rr = r * star * (1.0 + 0.1 * np.sin(z / 3.0))
        px = cx + rr * np.cos(th) + 0.37
        py = cy + 0.8 * rr * np.sin(th) + 0.21
        loops = [(px, py)]
        if k == 0:
            loops.append((cx + 0.3 * r * np.cos(th),
                          cy + 0.3 * r * np.sin(th)))
        for lx, ly in loops:
            mm = np.stack([origin[0] + lx * SPACING[0],
                           origin[1] + ly * SPACING[1],
                           np.full_like(lx, origin[2] + z * THICKNESS)],
                          axis=1)
            out.append(mm)
    return out


def phase_structures(cfg, state, work, rng):
    import medicalimageanalysis_tpu as mia
    from medicalimageanalysis_tpu.data import Data
    from medicalimageanalysis_tpu.structure.roi import Roi
    from medicalimageanalysis_tpu.utils.convert.contour import (
        _pick_raster_backend)

    t0 = time.perf_counter()
    s0, s1 = state["series"][0], state["series"][1]
    img = Data.image[s0["name"]]
    names = [f"ROI_{k}" for k in range(N_ROIS)]
    for k, name in enumerate(names):
        img.rois[name] = Roi(img, position=_roi_contours(
            cfg["ct_shape"], state["origin"], k, rng), name=name)
    rs_path = os.path.join(work, "rtstruct.dcm")
    img.create_rtstruct(roi_names=names, path=rs_path)
    # fresh registry: series 1 + 2 and the written RTSTRUCT
    mia.read_dicoms(file_list=s0["files"] + s1["files"] + [rs_path])
    by_uid = {Data.image[n].series_uid: n for n in Data.image_list}
    s0["name"], s1["name"] = by_uid[s0["uid"]], by_uid[s1["uid"]]
    img = Data.image[s0["name"]]
    check(sorted(img.rois) == sorted(names),
          f"structures: re-read ROIs {sorted(img.rois)}")
    backend = _pick_raster_backend()
    check(backend == "device" or state["on_cpu"],
          f"structures: raster backend {backend} on an accelerator")
    t1 = time.perf_counter()
    masks = {n: np.asarray(img.rois[n].compute_mask()) for n in names}
    t_mask = time.perf_counter() - t1
    bad = 0
    for n in names:
        ref = ref_rasterize(img.rois[n].contour_pixel, cfg["ct_shape"])
        check(masks[n].sum() > 0, f"structures: {n} mask is empty")
        bad += int(np.sum(masks[n] != ref))
    check(bad == 0, f"structures: {bad} mask voxels differ")
    report("structures", t0, float(bad), 0.0, "int32/float32 (no matmul)",
           f"rois={N_ROIS} backend={backend} compute_mask_s={t_mask:.3f}")
    state["roi_names"] = names


def phase_rigid(cfg, state):
    import medicalimageanalysis_tpu as mia
    from medicalimageanalysis_tpu.data import Data

    t0 = time.perf_counter()
    s0, s1 = state["series"][0], state["series"][1]
    rigid = mia.Rigid(s0["name"], s1["name"])
    rigid.compute_intensity(levels=((2, 120, 0.2), (1, 80, 0.05)))
    t_reg = time.perf_counter() - t0
    M = np.asarray(rigid.matrix, np.float64)
    T = state["T"]
    from scipy.spatial.transform import Rotation
    ang_err = float(np.degrees(Rotation.from_matrix(
        M[:3, :3] @ T[:3, :3].T).magnitude()))
    c = np.append(state["center"], 1.0)
    t_err = float(np.linalg.norm((M @ c - T @ c)[:3]))
    # tests/test_rigid.py: rotation recovery within 1.5 degrees
    # (test_rigid_intensity_rotation_recovery), translation within
    # 0.7 mm (test_rigid_intensity_registration)
    check(ang_err < 1.5, f"rigid: rotation error {ang_err} deg")
    check(t_err < 0.7, f"rigid: translation error {t_err} mm")

    t1 = time.perf_counter()
    out = rigid.create_image()
    t_img = time.perf_counter() - t1
    mov = Data.image[s1["name"]]
    Zo, Yo, Xo = out["array"].shape
    p2p_out = pixel_to_position(out["origin"], out["spacing"])
    p2p_mov = pixel_to_position(np.asarray(mov.origin),
                                np.asarray(mov.spacing))
    A = np.linalg.inv(p2p_mov) @ (M @ rigid.combo_matrix) @ p2p_out
    zz, yy, xx = np.meshgrid(np.arange(Zo), np.arange(Yo), np.arange(Xo),
                             indexing="ij")
    pix = np.stack([xx, yy, zz, np.ones_like(xx)]).reshape(4, -1)
    src = A @ pix
    coords = np.stack([src[2], src[1], src[0]]).reshape(3, Zo, Yo, Xo)
    ref = ref_trilinear(np.asarray(mov.array, np.float64), coords,
                        BACKGROUND)
    amb = edge_band(coords, mov.array.shape)
    rel, where = _rel_err(out["array"], ref, ~amb)
    check(rel <= 1e-4, f"rigid: create_image relative error {rel}; "
          f"{where}")
    report("rigid", t0, rel, 1e-4, HIGHEST + " geometry, " + GATHER,
           f"rot_err_deg={ang_err:.3g} (tol 1.5) trans_err_mm="
           f"{t_err:.4f} (tol 0.7) register_s={t_reg:.3f} "
           f"create_image_s={t_img:.3f} edge_band_voxels={int(amb.sum())}")


def _smooth_field(shape, amp_vox):
    """Smooth (3, Z, Y, X) voxel displacement field, rows (x, y, z)."""
    Z, Y, X = shape
    z = np.arange(Z)[:, None, None] / Z
    y = np.arange(Y)[None, :, None] / Y
    x = np.arange(X)[None, None, :] / X
    ux = amp_vox * np.sin(np.pi * z) * np.sin(2 * np.pi * y)
    uy = amp_vox * np.sin(np.pi * x) * np.cos(np.pi * z)
    uz = 0.5 * amp_vox * np.sin(np.pi * x) * np.sin(np.pi * y)
    return np.stack(np.broadcast_arrays(ux, uy, uz)).astype(np.float64)


def phase_deformable(cfg, state, work, rng):
    import medicalimageanalysis_tpu as mia
    from medicalimageanalysis_tpu.data import Data
    from medicalimageanalysis_tpu.ops.registration.dvf import invert_dvf
    from medicalimageanalysis_tpu.utils.creation import CreateDicomImage
    from medicalimageanalysis_tpu.utils.dose import register_dose_grid

    t0 = time.perf_counter()
    shape = tuple(cfg["demons_shape"])
    Z, Y, X = shape
    sp = (2 * SPACING[0], 2 * SPACING[1], THICKNESS)
    origin = state["origin"]
    fixed = np.clip(np.round(make_phantom(shape, rng)), -1024, 3071)
    u = _smooth_field(shape, 2.0)
    zz, yy, xx = np.meshgrid(np.arange(Z), np.arange(Y), np.arange(X),
                             indexing="ij")
    moving = ref_trilinear(fixed, np.stack([zz + u[2], yy + u[1],
                                            xx + u[0]]), -1000.0)
    uids = {}
    for tag, arr in (("fixed", fixed), ("moving", moving)):
        gen = CreateDicomImage(os.path.join(work, f"demons_{tag}"),
                               np.round(arr).astype(np.int16),
                               origin=list(origin), spacing=list(sp[:2]),
                               thickness=THICKNESS)
        gen.run(patient_id="SMOKE", description=f"demons {tag}")
        uids[tag] = gen.series
    mia.read_dicoms(folder_path=os.path.join(work, "demons_fixed"),
                    clear=False)
    mia.read_dicoms(folder_path=os.path.join(work, "demons_moving"),
                    clear=False)
    by_uid = {Data.image[n].series_uid: n for n in Data.image_list}
    f_name, m_name = by_uid[uids["fixed"]], by_uid[uids["moving"]]
    f_arr = np.asarray(Data.image[f_name].array, np.float64)
    m_arr = np.asarray(Data.image[m_name].array, np.float64)

    t1 = time.perf_counter()
    defo = mia.Deformable(reference_name=f_name, moving_name=m_name)
    defo.compute_demons(method="fast", iterations=cfg["demons_iters"],
                        std=1, crop=0)
    out = np.asarray(defo.create_image()["array"], np.float64)
    t_dev = time.perf_counter() - t1
    # reference: the same sampling field (the library's inverse of the
    # stored point-displacement DVF), resampled by scipy
    inv = invert_dvf(np.asarray(defo.dvf), defo.spacing)
    inv_vox = inv / np.asarray(sp)
    coords = np.stack([zz + inv_vox[..., 2], yy + inv_vox[..., 1],
                       xx + inv_vox[..., 0]])
    ref = ref_trilinear(m_arr, coords, BACKGROUND)
    amb = edge_band(coords, shape)
    rel, where = _rel_err(out, ref, ~amb)
    check(rel <= 1e-4, f"deformable: create_image relative error {rel}; "
          f"{where}")
    valid = out != BACKGROUND
    mse0 = float(np.mean((m_arr - f_arr)[valid] ** 2))
    mse1 = float(np.mean((out - f_arr)[valid] ** 2))
    check(mse1 * 2.0 <= mse0, f"deformable: MSE {mse0} -> {mse1}")

    # DVH: a dose grid on the structure image, exported with
    # Dose.create_rtdose, re-read, cumulative curve vs numpy counts
    t2 = time.perf_counter()
    img_name = state["series"][0]["name"]
    img = Data.image[img_name]
    Zc, Yc, Xc = img.array.shape
    dz = np.linspace(-1, 1, Zc)[:, None, None]
    dy = np.linspace(-1, 1, Yc)[None, :, None]
    dx = np.linspace(-1, 1, Xc)[None, None, :]
    dose_arr = (70.0 * np.exp(-(dx ** 2 / 0.2 + dy ** 2 / 0.3
                                + dz ** 2 / 0.5))).astype(np.float32)
    src = register_dose_grid(dose_arr, img, name="smoke_dose")
    rd_path = os.path.join(work, "rtdose.dcm")
    src.create_rtdose(path=rd_path)
    before = set(Data.dose_list)
    mia.read_dicoms(file_list=[rd_path], clear=False)
    new = [n for n in Data.dose_list if n not in before]
    check(len(new) == 1, f"deformable: RTDOSE re-read gave {new}")
    dose = Data.dose[new[0]]
    d_err = float(np.abs(np.asarray(dose.array, np.float64)
                         - dose_arr).max())
    check(d_err <= 1e-5, f"deformable: RTDOSE round trip error {d_err}")
    bad = 0
    for roi in state["roi_names"]:
        bins, vol_pct = dose.compute_dvh_curve(img_name, roi)
        vals = dose.compute_roi_dose_array(img_name, roi)
        below = ref_below_counts(vals, bins)
        ref_pct = 100.0 * (1.0 - below / vals.size)
        bad += int(np.sum(np.abs(vol_pct - ref_pct) > 0))
    check(bad == 0, f"deformable: {bad} DVH bins differ from numpy")
    report("deformable", t0, rel, 1e-4, HIGHEST + " smoothing, " + GATHER,
           f"mse_before={mse0:.4g} mse_after={mse1:.4g} "
           f"demons_and_image_s={t_dev:.3f} dvh_bins_mismatch={bad} "
           f"edge_band_voxels={int(amb.sum())} "
           f"dvh_s={time.perf_counter() - t2:.3f} shape={list(shape)}")


# ---------------------------------------------------------------------
# four-GPU mesh paths
# ---------------------------------------------------------------------
def phase_multi_preprocess(cfg, rng):
    import jax
    from medicalimageanalysis_tpu.parallel.batch import preprocess_batch
    from medicalimageanalysis_tpu.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    n = len(jax.devices())
    raw = np.stack([np.round(make_phantom(cfg["ct_shape"], rng))
                    .astype(np.int16) for _ in range(n)])
    slope = np.ones(n, np.float32)
    icept = np.zeros(n, np.float32)
    mesh = make_mesh(n, space=1)
    v4, m4 = preprocess_batch(raw, slope, icept, out_shape=cfg["pre_out"],
                              ffs_op="ax_rot2", mesh=mesh)
    check(len(v4.sharding.device_set) == n,
          f"multi preprocess: output on {len(v4.sharding.device_set)} "
          "devices")
    v4, m4 = np.asarray(v4), np.asarray(m4)
    v1, m1 = preprocess_batch(raw, slope, icept, out_shape=cfg["pre_out"],
                              ffs_op="ax_rot2")
    v1, m1 = np.asarray(v1), np.asarray(m1)
    err = float(np.abs(v4 - v1).max())
    check(err <= 1e-3, f"multi preprocess: |d| {err} vs one device")
    # mask flips are allowed only within 1e-2 HU of the threshold
    bad = 0
    for b in np.unique(np.nonzero(m4 != m1)[0]):
        _, ref_b = ref_preprocess(raw[b], 1.0, 0.0, cfg["pre_out"], 2, 1.0)
        flip = m4[b] != m1[b]
        bad += int(np.sum(flip & (np.abs(ref_b - THRESHOLD) > 1e-2)))
    check(bad == 0, f"multi preprocess: {bad} mask voxels differ")
    report("multi_preprocess", t0, err, 1e-3, HIGHEST,
           f"mesh={dict(mesh.shape)} batch={n}")


def phase_multi_registration(cfg, rng):
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P
    from medicalimageanalysis_tpu.parallel.batch import (
        make_registration_step)
    from medicalimageanalysis_tpu.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    n = len(jax.devices())
    mesh = make_mesh(n, space=2)
    vol_shape = tuple(cfg["multi_reg_shape"])
    B = mesh.shape["data"] * 2
    Z, Y, X = vol_shape
    zz, yy, xx = np.mgrid[0:Z, 0:Y, 0:X].astype(np.float32)
    blob = np.exp(-(((zz - Z / 2) / (Z / 4)) ** 2
                    + ((yy - Y / 2) / (Y / 4)) ** 2
                    + ((xx - X / 2) / (X / 4)) ** 2))
    refs = (np.broadcast_to(blob, (B,) + vol_shape)
            + rng.normal(0, 0.01, (B,) + vol_shape)).astype(np.float32)
    movs = np.roll(refs, shift=1, axis=3).copy()
    train_step, init = make_registration_step(vol_shape, stride=2)
    vol_sh = NamedSharding(mesh, P("data", "space", None, None))
    batch_sh = NamedSharding(mesh, P("data"))
    step = jax.jit(train_step,
                   in_shardings=(batch_sh, None, vol_sh, vol_sh),
                   out_shardings=(batch_sh, None, None))
    p, o = init(B)
    p = jax.device_put(p, batch_sh)
    r_d, m_d = jax.device_put(refs, vol_sh), jax.device_put(movs, vol_sh)
    losses4 = []
    for _ in range(3):
        p, o, loss = step(p, o, r_d, m_d)
        losses4.append(float(loss))
    check(len(p.sharding.device_set) == n,
          "multi registration: poses not sharded over the mesh")
    step1 = jax.jit(train_step)
    p1, o1 = init(B)
    losses1 = []
    for _ in range(3):
        p1, o1, loss = step1(p1, o1, refs, movs)
        losses1.append(float(loss))
    err = max(abs(a - b) / max(abs(b), 1e-12)
              for a, b in zip(losses4, losses1))
    check(np.isfinite(losses4).all(), "multi registration: non-finite")
    check(err <= 1e-3, f"multi registration: loss rel err {err}")
    report("multi_registration", t0, err, 1e-3, HIGHEST + " geometry",
           f"mesh={dict(mesh.shape)} pairs={B} shape={list(vol_shape)} "
           f"losses={[round(v, 6) for v in losses4]}")


def phase_multi_demons(cfg, rng):
    import jax
    from medicalimageanalysis_tpu.ops.registration.demons import (
        demons_registration)
    from medicalimageanalysis_tpu.parallel.halo import demons_z_sharded
    from medicalimageanalysis_tpu.parallel.mesh import make_mesh

    t0 = time.perf_counter()
    n = len(jax.devices())
    shape = tuple(cfg["demons_shape"])
    fixed = make_phantom(shape, rng) / 1000.0
    u = _smooth_field(shape, 1.5)
    Z, Y, X = shape
    zz, yy, xx = np.meshgrid(np.arange(Z), np.arange(Y), np.arange(X),
                             indexing="ij")
    moving = ref_trilinear(fixed, np.stack([zz + u[2], yy + u[1],
                                            xx + u[0]]), -1.0)
    sp = (2 * SPACING[0], 2 * SPACING[1], THICKNESS)
    mesh = make_mesh(n, space=n)

    band = max(1, min(4, Z // n // 4))
    near = np.zeros(Z, bool)              # rows next to a shard cut
    for cut in range(Z // n, Z, Z // n):
        near[cut - band:cut + band] = True

    def compare(iterations):
        """Sharded vs dense field after `iterations`, and the dense
        field's own spread when its moving image changes by 1e-6.
        Demons is bistable at the |diff| > threshold knife edge (noisy
        air), so rounding can flip a voxel onto the other branch; the
        sharded field may differ by at most twice that floor. A halo
        or boundary fault shows at shard cuts, far above it."""
        kw = dict(method="fast", iterations=iterations, std=1)
        ref = np.asarray(demons_registration(fixed, moving, sp, **kw))
        got = np.asarray(demons_z_sharded(fixed, moving, mesh, sp, **kw))
        d = np.abs(got - ref).max(axis=-1)
        f_max = f_mean = 0.0
        for seed in (1, 2):
            noise = np.random.default_rng(seed).normal(0, 1e-6, Z * Y * X)
            pert = (moving + noise.reshape(shape)).astype(np.float32)
            dp = np.abs(np.asarray(demons_registration(
                fixed, pert, sp, **kw)) - ref).max(axis=-1)
            f_max = max(f_max, float(dp.max()))
            f_mean = max(f_mean, float(dp.mean()))
        tol_max = max(2.0 * f_max, 1e-4)
        tol_mean = max(2.0 * f_mean, 1e-6)
        z_worst = int(np.unravel_index(int(np.argmax(d)), d.shape)[0])
        note = (f"iter{iterations}: max {d.max():.3g} mm (tol "
                f"{tol_max:.3g}) mean {d.mean():.3g} (tol {tol_mean:.3g}) "
                f"at_cuts_max {d[near].max():.3g} elsewhere_max "
                f"{d[~near].max():.3g} worst_z {z_worst} dense_floor_max "
                f"{f_max:.3g} dense_floor_mean {f_mean:.3g}")
        check(float(d.max()) <= tol_max and float(d.mean()) <= tol_mean,
              f"multi demons: {note}")
        return float(d.max()), tol_max, note

    _, _, early = compare(2)
    err, tol, full = compare(cfg["multi_demons_iters"])
    report("multi_demons", t0, err, tol, HIGHEST + " smoothing",
           f"mesh={dict(mesh.shape)} shape={list(shape)} {early}; {full}")


# ---------------------------------------------------------------------
def _gpu_name_and_power():
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                            "--format=csv,noheader"],
                           capture_output=True, text=True, timeout=60)
        return r.stdout.strip() or f"nvidia-smi rc={r.returncode}"
    except (OSError, subprocess.SubprocessError) as e:
        return f"nvidia-smi unavailable ({type(e).__name__})"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--multi", action="store_true",
                    help="run the four-device mesh paths only")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny shapes on any backend (no device line)")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    cfg = TINY if args.tiny else FULL

    import jax
    devices = jax.devices()
    dev = devices[0]
    if not args.tiny and dev.platform != "gpu":
        print(f"chip_smoke: no GPU found (JAX platform {dev.platform!r})",
              file=sys.stderr)
        return 1
    need = 4 if args.multi else 1
    if not args.tiny and len(devices) < need:
        print(f"chip_smoke: need {need} GPUs, JAX sees {len(devices)}",
              file=sys.stderr)
        return 1
    if args.tiny and args.multi and len(devices) < 4:
        print("chip_smoke: --tiny --multi needs 4 devices (set XLA_FLAGS="
              "--xla_force_host_platform_device_count=4)", file=sys.stderr)
        return 1

    sys.path.insert(0, HERE)
    import importlib.util

    from medicalimageanalysis_tpu import native
    from medicalimageanalysis_tpu.data import Data
    import medicalimageanalysis_tpu.ops  # noqa: F401  (sets the cache)

    print(_gpu_name_and_power(), flush=True)
    print(f"jax.devices(): {devices}", flush=True)
    print(f"compile cache: {jax.config.jax_compilation_cache_dir}",
          flush=True)
    print("native libmiadicom: "
          + ("loaded" if native.get_lib() is not None
             else "not loaded (pure-Python fallback)"), flush=True)
    for mod in ("cv2", "psutil"):
        print(f"import {mod}: "
              + ("available" if importlib.util.find_spec(mod)
                 else "not installed"), flush=True)

    rng = np.random.default_rng(args.seed)
    on_cpu = dev.platform == "cpu"
    Data.clear()
    if args.multi:
        phase_multi_preprocess(cfg, rng)
        phase_multi_registration(cfg, rng)
        phase_multi_demons(cfg, rng)
    else:
        with tempfile.TemporaryDirectory(prefix="mia_smoke_") as work:
            state = phase_ingest(cfg, work, rng)
            state["on_cpu"] = on_cpu
            phase_preprocess(cfg, state)
            phase_structures(cfg, state, work, rng)
            phase_rigid(cfg, state)
            phase_deformable(cfg, state, work, rng)
        Data.clear()
    loaded = [m for m in ("cv2", "pandas", "PIL") if m in sys.modules]
    check(on_cpu or not loaded, f"main path imported {loaded}")
    if args.tiny:
        print("chip_smoke: tiny rehearsal passed", flush=True)
        return 0
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
