"""Multi-device scaling tests on the virtual CPU mesh."""

import numpy as np
import pytest

import jax


def _require_8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")


def test_demons_batch_sharded(rng):
    _require_8()
    from medicalimageanalysis_tpu.parallel.batch import demons_batch
    from medicalimageanalysis_tpu.parallel.mesh import make_mesh
    mesh = make_mesh(8, space=2)

    zz, yy, xx = np.mgrid[0:8, 0:16, 0:16]
    blob = np.exp(-(((zz - 4) / 2.0) ** 2 + ((yy - 8) / 4.0) ** 2
                    + ((xx - 8) / 4.0) ** 2)).astype(np.float32)
    B = 4
    fixed = np.broadcast_to(blob, (B, 8, 16, 16)).copy()
    moving = np.roll(fixed, 1, axis=3).copy()

    dvfs = np.asarray(demons_batch(fixed, moving, iterations=20,
                                   mesh=mesh))
    assert dvfs.shape == (B, 8, 16, 16, 3)
    # all pairs identical -> identical fields
    np.testing.assert_allclose(dvfs[0], dvfs[1], atol=1e-5)
    # the field reduces the mismatch
    from medicalimageanalysis_tpu.ops.registration.dvf import warp_volume
    warped = np.asarray(warp_volume(moving[0], dvfs[0], (1, 1, 1)))
    assert np.abs(warped - fixed[0]).mean() \
        < 0.5 * np.abs(moving[0] - fixed[0]).mean()


def test_registration_step_converges():
    from medicalimageanalysis_tpu.parallel.batch import (
        make_registration_step)
    zz, yy, xx = np.mgrid[0:8, 0:16, 0:16]
    blob = np.exp(-(((zz - 4) / 2.0) ** 2 + ((yy - 8) / 4.0) ** 2
                    + ((xx - 8) / 4.0) ** 2)).astype(np.float32)
    B = 2
    refs = np.broadcast_to(blob, (B, 8, 16, 16)).copy()
    movs = np.roll(refs, 1, axis=3).copy()

    train_step, init = make_registration_step((8, 16, 16), lr=0.1,
                                              stride=1)
    params, opt_state = init(B)
    step = jax.jit(train_step)
    losses = []
    for _ in range(30):
        params, opt_state, loss = step(params, opt_state, refs, movs)
        losses.append(float(loss))
    assert losses[-1] < 0.5 * losses[0]


def test_mesh_shapes():
    _require_8()
    from medicalimageanalysis_tpu.parallel.mesh import make_mesh
    mesh = make_mesh(8, space=4)
    assert dict(mesh.shape) == {"data": 2, "space": 4}
    with pytest.raises(ValueError):
        make_mesh(8, space=3)


def test_input_mhd_roi(tmp_path, rng):
    """Image.input_mhd: label volume -> ROI masks."""
    import medicalimageanalysis_tpu as mia
    from medicalimageanalysis_tpu.data import Data
    from medicalimageanalysis_tpu.read.mhd import write_mhd_volume
    from helpers import write_ct_series

    arr = rng.integers(0, 100, size=(6, 16, 16)).astype(np.int16)
    write_ct_series(tmp_path / "ct", arr, spacing=(1, 1), thickness=2.0)
    mia.read_dicoms(folder_path=str(tmp_path))
    img = Data.image["CT 01"]

    labels = np.zeros((6, 16, 16), np.uint8)
    labels[1:4, 2:8, 2:8] = 1
    labels[2:5, 9:14, 9:14] = 2
    write_mhd_volume(tmp_path / "labels.mhd", labels)
    img.input_mhd(str(tmp_path / "labels.mhd"), ["A", "B"], [1, 2])
    assert "A" in img.rois and "B" in img.rois
    mask_a = img.rois["A"].compute_mask()
    assert mask_a[2, 4, 4] == 1
    assert mask_a[3, 11, 11] == 0


def test_ingest_cohort(tmp_path, rng):
    _require_8()
    import medicalimageanalysis_tpu as mia
    from medicalimageanalysis_tpu.data import Data
    from medicalimageanalysis_tpu.parallel.cohort import ingest_cohort
    from medicalimageanalysis_tpu.parallel.mesh import make_mesh
    from helpers import write_ct_series

    for s in range(4):
        arr = rng.integers(-500, 1500, size=(8, 32, 32)).astype(np.int16)
        write_ct_series(tmp_path / f"s{s}", arr, spacing=(1, 1),
                        thickness=2.0)
    mesh = make_mesh(8, space=2)
    results = ingest_cohort(folder_path=str(tmp_path),
                            out_shape=(8, 16, 16), mesh=mesh)
    assert len(results) == 4
    for name, r in results.items():
        assert r["volume"].shape == (8, 16, 16)
        assert r["mask"].shape == (8, 16, 16)
        assert Data.image[name].array is not None


def test_icp_rigid_batch():
    from scipy.spatial.transform import Rotation
    from medicalimageanalysis_tpu.ops.registration.icp import (
        icp_rigid_batch)
    rng = np.random.default_rng(5)
    B = 3
    base = rng.normal(size=(600, 3)) * [30, 20, 40]
    sources = np.stack([base] * B)
    targets = []
    trues = []
    for b in range(B):
        R = Rotation.from_euler("xyz", rng.uniform(-5, 5, 3),
                                degrees=True).as_matrix()
        t = rng.uniform(-8, 8, 3)
        targets.append(base @ R.T + t)
        trues.append((R, t))
    targets = np.stack(targets)
    ms, rms = icp_rigid_batch(sources, targets, distance=1e-7,
                              iterations=100)
    for b in range(B):
        moved = sources[b] @ ms[b][:3, :3].T + ms[b][:3, 3]
        err = np.sqrt(np.mean(np.sum((moved - targets[b]) ** 2, axis=1)))
        assert err < 0.5, (b, err)


def test_gaussian_z_sharded_matches_unsharded(rng):
    _require_8()
    from medicalimageanalysis_tpu.parallel.halo import gaussian_z_sharded
    from medicalimageanalysis_tpu.parallel.mesh import make_mesh
    from scipy import ndimage

    mesh = make_mesh(8, space=4)
    vol = rng.normal(size=(32, 16, 16)).astype(np.float32)
    out = np.asarray(gaussian_z_sharded(vol, 1.5, mesh))
    golden = ndimage.gaussian_filter1d(vol, sigma=1.5, axis=0,
                                       mode="nearest", truncate=4.0)
    np.testing.assert_allclose(out, golden, atol=2e-3)


def test_demons_z_sharded_matches_single_device(rng):
    """One volume z-sharded over 'space' (loop-invariant halo slab +
    per-iteration smoothing halo + pmax) must match the single-device
    demons loop to f32 tolerance for deformations within the halo."""
    from medicalimageanalysis_tpu.ops.registration.demons import (
        demons_registration)
    from medicalimageanalysis_tpu.parallel.halo import demons_z_sharded
    from medicalimageanalysis_tpu.parallel.mesh import make_mesh

    zz, yy, xx = np.mgrid[0:32, 0:24, 0:40].astype(np.float32)
    fixed = np.exp(-(((zz - 16) / 6) ** 2 + ((yy - 12) / 5) ** 2
                     + ((xx - 20) / 8) ** 2)).astype(np.float32) * 100
    moving = np.roll(fixed, shift=2, axis=2) + \
        rng.normal(0, 0.1, fixed.shape).astype(np.float32)

    mesh = make_mesh(8, space=4)
    for method in ("fast", "demons"):
        ref = demons_registration(fixed, moving, (1.0, 1.0, 1.0),
                                  method=method, iterations=8, std=1)
        got = demons_z_sharded(fixed, moving, mesh, (1.0, 1.0, 1.0),
                               method=method, iterations=8, std=1)
        assert got.shape == fixed.shape + (3,)
        err = np.abs(got - ref).max()
        assert err < 2e-3, f"{method}: sharded demons diverges ({err})"
    # the fast variant must actually have recovered some of the shift
    assert np.abs(got[..., 0]).max() > 0.3


def test_demons_z_sharded_lncc_matches_single_device(rng):
    """LNCC forces z-sharded: windowed moments span shard boundaries
    (box-sum halo with GLOBAL-EDGE ZEROING — edge replication would
    silently diverge from the dense clipped-matrix path) and must
    match the single-device LNCC trajectory to f32 tolerance, on an
    INVERTED-contrast pair where SSD does nothing."""
    from medicalimageanalysis_tpu.ops.registration.demons import (
        demons_registration)
    from medicalimageanalysis_tpu.parallel.halo import demons_z_sharded
    from medicalimageanalysis_tpu.parallel.mesh import make_mesh

    zz, yy, xx = np.mgrid[0:32, 0:24, 0:40].astype(np.float32)
    fixed = (np.exp(-(((zz - 16) / 6) ** 2 + ((yy - 12) / 5) ** 2
                      + ((xx - 20) / 8) ** 2)) * 100
             + np.exp(-(((zz - 8) / 4) ** 2 + ((yy - 8) / 4) ** 2
                        + ((xx - 10) / 5) ** 2)) * 60
             ).astype(np.float32)
    fixed += rng.normal(0, 0.5, fixed.shape).astype(np.float32)
    moving = (120.0 - np.roll(fixed, shift=2, axis=2)).astype(
        np.float32)

    mesh = make_mesh(8, space=4)
    ref = demons_registration(fixed, moving, (1.0, 1.0, 1.0),
                              method="fast", iterations=12, std=1,
                              step=1.0, forces="lncc")
    got = demons_z_sharded(fixed, moving, mesh, (1.0, 1.0, 1.0),
                           method="fast", iterations=12, std=1,
                           step=1.0, forces="lncc")
    assert got.shape == fixed.shape + (3,)
    d = np.abs(got - ref)
    # the per-iteration peak normalization amplifies f32 summation-
    # order noise into a small trajectory wobble (heavier in the max
    # than the mean); single-iteration parity is ~4e-5
    assert d.mean() < 5e-4, f"sharded LNCC diverges (mean {d.mean()})"
    assert d.max() < 0.05, f"sharded LNCC diverges (max {d.max()})"
    # and it actually moved (inverted contrast: SSD would stall)
    assert np.abs(got[..., 0]).max() > 0.3
    with pytest.raises(ValueError, match="forces"):
        demons_z_sharded(fixed, moving, mesh, forces="ncc")


def test_register_batch_mi_metric(rng):
    """metric='mi' threads through the batched cohort registration
    (static arg through lax.map + shard_map)."""
    _require_8()
    from medicalimageanalysis_tpu.models.rigid_intensity import (
        register_rigid_intensity_batch)
    from medicalimageanalysis_tpu.parallel.mesh import make_mesh

    zz, yy, xx = np.mgrid[0:8, 0:24, 0:24].astype(np.float32)
    base = np.exp(-(((zz - 4) / 2) ** 2 + ((yy - 12) / 5) ** 2
                    + ((xx - 12) / 5) ** 2)).astype(np.float32)
    B = 4
    refs = np.broadcast_to(base, (B, 8, 24, 24)).copy()
    refs += rng.normal(0, 0.01, refs.shape).astype(np.float32)
    movs = np.roll(1.0 - refs, shift=1, axis=3).copy()  # inverted + shift

    eye = np.broadcast_to(np.eye(4, dtype=np.float32), (B, 4, 4)).copy()
    centers = np.tile(np.array([12.0, 12.0, 4.0], np.float32), (B, 1))
    mesh = make_mesh(8, space=2)
    poses, losses = register_rigid_intensity_batch(
        refs, movs, eye, eye, centers, metric="mi",
        levels=((1, 30, 0.05),), mesh=mesh)
    assert poses.shape == (B, 6) and np.isfinite(losses).all()
    # inverted intensities: MI still pulls x-translation toward +1
    assert np.all(poses[:, 3] > 0.25)


def test_demons_batch_z_sharded_matches_single_device(rng):
    """B pairs x z-shards over the FULL ('data', 'space') mesh at once
    (VERDICT r2 next #6): every pair's field matches its single-device
    demons trajectory to f32 tolerance."""
    _require_8()
    from medicalimageanalysis_tpu.ops.registration.demons import (
        demons_registration)
    from medicalimageanalysis_tpu.parallel.halo import (
        demons_batch_z_sharded)
    from medicalimageanalysis_tpu.parallel.mesh import make_mesh

    zz, yy, xx = np.mgrid[0:16, 0:20, 0:32].astype(np.float32)
    base = np.exp(-(((zz - 8) / 4) ** 2 + ((yy - 10) / 4) ** 2
                    + ((xx - 16) / 6) ** 2)).astype(np.float32) * 100
    B = 4
    fixeds = np.stack([
        base + rng.normal(0, 0.05, base.shape).astype(np.float32)
        for _ in range(B)])
    movings = np.stack([
        np.roll(fixeds[b], shift=1 + (b % 2), axis=2) for b in range(B)])

    mesh = make_mesh(8, space=4)        # ('data'=2, 'space'=4)
    got = demons_batch_z_sharded(fixeds, movings, mesh, (1, 1, 1),
                                 method="fast", iterations=6, std=1)
    assert got.shape == (B, 16, 20, 32, 3)
    for b in range(B):
        ref = demons_registration(fixeds[b], movings[b], (1, 1, 1),
                                  method="fast", iterations=6, std=1)
        err = np.abs(got[b] - ref).max()
        assert err < 2e-3, f"pair {b} diverges ({err})"
    # shifts actually recovered
    assert np.abs(got[..., 0]).max() > 0.2

    # divisibility contracts
    with pytest.raises(ValueError, match="not divisible"):
        demons_batch_z_sharded(fixeds[:3], movings[:3], mesh)


def test_warp_z_sharded_matches_warp_volume(rng):
    """z-sharded DVF warp (halo slab + fused disp kernel per shard)
    must match the single-device warp_volume exactly where the field
    stays within the halo reach, including background at the global
    z edges."""
    _require_8()
    from medicalimageanalysis_tpu.ops.registration.dvf import warp_volume
    from medicalimageanalysis_tpu.parallel.halo import warp_z_sharded
    from medicalimageanalysis_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(8, space=4)
    vol = rng.normal(size=(32, 16, 24)).astype(np.float32) * 100
    # rough random field; |dz| < 4 mm stays within halo reach but
    # pushes edge rows out of the volume (background semantics)
    dvf = rng.uniform(-3.5, 3.5, size=(32, 16, 24, 3)).astype(np.float32)
    spacing = (1.0, 1.0, 1.0)

    golden = np.asarray(warp_volume(vol, dvf, spacing, background=-3001))
    got = np.asarray(warp_z_sharded(vol, dvf, mesh, spacing,
                                    background=-3001, halo=8))
    np.testing.assert_allclose(got, golden, atol=2e-3)
    # the edge rows must actually exercise the background path
    assert np.any(golden == -3001)


def test_warp_z_sharded_anisotropic_spacing(rng):
    """mm -> voxel conversion respects [sx, sy, sz]."""
    _require_8()
    from medicalimageanalysis_tpu.ops.registration.dvf import warp_volume
    from medicalimageanalysis_tpu.parallel.halo import warp_z_sharded
    from medicalimageanalysis_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(8, space=2)
    vol = rng.normal(size=(16, 12, 20)).astype(np.float32)
    dvf = rng.uniform(-4, 4, size=(16, 12, 20, 3)).astype(np.float32)
    spacing = (0.8, 1.2, 2.5)
    golden = np.asarray(warp_volume(vol, dvf, spacing, background=0.0))
    got = np.asarray(warp_z_sharded(vol, dvf, mesh, spacing, halo=8))
    np.testing.assert_allclose(got, golden, atol=2e-3)


def test_warp_z_sharded_halo_overflow_warns(rng):
    """z-motion beyond the halo reach: affected voxels take the
    background (never a silently wrong value) and a RuntimeWarning
    names the remedy."""
    _require_8()
    import warnings as _w
    from medicalimageanalysis_tpu.parallel.halo import warp_z_sharded
    from medicalimageanalysis_tpu.parallel.mesh import make_mesh

    mesh = make_mesh(8, space=4)
    vol = rng.normal(size=(32, 8, 8)).astype(np.float32)
    dvf = np.zeros((32, 8, 8, 3), np.float32)
    # sample 12 rows away: IN-volume (z=20) but beyond the halo-8 cap
    # of 6 rows — must background + warn, never silently clamp
    dvf[8, :, :, 2] = 12.0
    with _w.catch_warnings(record=True) as rec:
        _w.simplefilter("always")
        out = np.asarray(warp_z_sharded(vol, dvf, mesh, halo=8,
                                        background=-3001))
    assert any("halo" in str(r.message) for r in rec)
    assert np.all(out[8] == -3001)
    # untouched rows stay exact (identity warp)
    np.testing.assert_allclose(out[0], vol[0], atol=1e-4)


def test_dvh_batch_matches_host(rng):
    """Cohort DVH panel == per-pair host dvh_statistics, sharded and
    unsharded; empty masks come back NaN with volume 0."""
    _require_8()
    from medicalimageanalysis_tpu.ops.dvh import dvh_statistics
    from medicalimageanalysis_tpu.parallel.batch import dvh_batch
    from medicalimageanalysis_tpu.parallel.mesh import make_mesh

    B, shape = 8, (6, 12, 10)
    doses = rng.uniform(0, 72, size=(B,) + shape).astype(np.float32)
    masks = (rng.random((B,) + shape) > 0.4).astype(np.uint8)
    masks[5] = 0  # empty-mask pair
    vox_cc = 0.9 * 1.1 * 2.0 / 1000.0

    out = dvh_batch(doses, masks, vox_cc)
    mesh = make_mesh(8, space=1)
    sharded = dvh_batch(doses, masks, vox_cc, mesh=mesh)
    for k in out:
        np.testing.assert_allclose(sharded[k], out[k], atol=1e-5,
                                   err_msg=k)

    for i in (0, 3, 7):
        ref = dvh_statistics(doses[i][masks[i] > 0], vox_cc)
        for k, v in ref.items():
            if k == "ROI":
                continue
            assert out[k][i] == pytest.approx(v, rel=1e-5, abs=1e-4), \
                f"pair {i} key {k}"
    assert out["Volume (cc)"][5] == 0.0
    for k in ("Dmean", "Dmin", "Dmax", "Dmedian", "Dstd", "D95"):
        assert np.isnan(out[k][5]), k
    with pytest.raises(ValueError):
        dvh_batch(doses[:3], masks[:3], vox_cc, mesh=mesh)
    with pytest.raises(ValueError):
        dvh_batch(doses[:, 0], masks[:, 0], vox_cc)


def test_gamma_batch_matches_single(rng):
    """Cohort gamma == per-pair ops.gamma.gamma_index (same layout),
    sharded and unsharded; all-zero refs report 100% / 0 analysed."""
    _require_8()
    from medicalimageanalysis_tpu.ops.gamma import (fine_grid_layout,
                                                    gamma_index,
                                                    upsample_to_fine)
    from medicalimageanalysis_tpu.parallel.batch import gamma_batch
    from medicalimageanalysis_tpu.parallel.mesh import make_mesh

    B, shape, sp = 4, (6, 14, 12), (2.5, 2.5, 2.5)
    zz, yy, xx = np.mgrid[0:shape[0], 0:shape[1], 0:shape[2]]
    base = 60 * np.exp(-((zz - 3) ** 2 / 8 + (yy - 7) ** 2 / 30
                         + (xx - 6) ** 2 / 24)).astype(np.float32)
    refs = np.stack([base * (1 + 0.05 * i) for i in range(B)])
    evals = np.stack([np.roll(r, 1, axis=2) * 1.02 for r in refs])
    refs[3] = 0.0  # all-zero reference pair

    out = gamma_batch(refs, evals, sp, dose_pct=3.0, dta_mm=3.0,
                      return_maps=True)
    mesh = make_mesh(8, space=2)
    sharded = gamma_batch(refs, evals, sp, mesh=mesh)
    for k in ("pass_rate", "mean", "max", "analysed_voxels"):
        np.testing.assert_allclose(sharded[k], out[k], atol=1e-4,
                                   err_msg=k)

    layout = fine_grid_layout(sp, 3.0, None, 2.0)
    for i in (0, 2):
        fine = np.asarray(upsample_to_fine(evals[i], layout[0],
                                           layout[1]))
        ref_out = gamma_index(refs[i], fine, sp, dose_pct=3.0,
                              dta_mm=3.0)
        assert out["pass_rate"][i] == pytest.approx(
            ref_out["pass_rate"], abs=1e-3)
        assert out["mean"][i] == pytest.approx(ref_out["mean"], abs=1e-4)
        assert out["max"][i] == pytest.approx(ref_out["max"], abs=1e-4)
        np.testing.assert_allclose(out["gamma"][i], ref_out["gamma"],
                                   atol=1e-5)
    assert out["pass_rate"][3] == 100.0
    assert out["analysed_voxels"][3] == 0
    with pytest.raises(ValueError):
        gamma_batch(refs, evals, sp, cap=0.5)
    with pytest.raises(ValueError):
        gamma_batch(refs[:3], evals[:3], sp, mesh=mesh)


def _star_contour(cx, cy, r, z, n=24, wobble=0.35, seed=0):
    rng2 = np.random.default_rng(seed)
    th = np.linspace(0, 2 * np.pi, n, endpoint=False)
    rr = r * (1.0 + wobble * rng2.uniform(-1, 1, n))
    return np.stack([cx + rr * np.cos(th), cy + rr * np.sin(th),
                     np.full(n, float(z))], axis=1)


def test_rasterize_batch_matches_cv2(rng):
    """Cohort rasterization (VERDICT r3 #1): all ROIs in one pooled
    device pass, bit-parity with the per-ROI cv2 backend, including
    holes (XOR), out-of-range slices, and bbox tile classes of mixed
    sizes."""
    from medicalimageanalysis_tpu.parallel.batch import rasterize_batch
    from medicalimageanalysis_tpu.utils.convert.contour import (
        _rasterize_plane)

    dims = (10, 72, 64)
    sets = []
    for b in range(3):
        contours = []
        for z in range(2, 8):
            contours.append(_star_contour(20 + 6 * b, 30, 11 + 2 * b,
                                          z, seed=10 * b + z))
            if z in (4, 5):  # hole: XORs against the outer contour
                contours.append(_star_contour(20 + 6 * b, 30, 4, z,
                                              wobble=0.1,
                                              seed=99 + b))
        # a tiny second structure + an out-of-range contour
        contours.append(_star_contour(52, 58, 3, 6, wobble=0.1,
                                      seed=7 + b))
        contours.append(_star_contour(30, 30, 8, 11 + b, seed=3))
        sets.append(contours)

    out = rasterize_batch(sets, dims, plane="Axial")
    assert out.shape == (3,) + dims
    for b, contours in enumerate(sets):
        gold = _rasterize_plane(contours, dims, "Axial", backend="cv2")
        np.testing.assert_array_equal(out[b], gold)


def test_rasterize_batch_coronal_and_mesh(rng):
    from medicalimageanalysis_tpu.parallel.batch import rasterize_batch
    from medicalimageanalysis_tpu.parallel.mesh import make_mesh
    from medicalimageanalysis_tpu.utils.convert.contour import (
        _rasterize_plane)

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 devices")
    dims = (8, 24, 40)
    # coronal contours: (x, z) vary, y = slice index
    sets = []
    for b in range(8):
        th = np.linspace(0, 2 * np.pi, 16, endpoint=False)
        contours = []
        for y in range(3, 7):
            contours.append(np.stack(
                [12 + (4 + b % 3) * np.cos(th),
                 np.full(16, float(y)),
                 3.2 + 2.5 * np.sin(th)], axis=1))
        sets.append(contours)

    single = rasterize_batch(sets, dims, plane="Coronal")
    for b in range(8):
        gold = _rasterize_plane(sets[b], dims, "Coronal",
                                backend="cv2")
        np.testing.assert_array_equal(single[b], gold)

    mesh = make_mesh(8, space=1)
    sharded = rasterize_batch(sets, dims, plane="Coronal", mesh=mesh)
    np.testing.assert_array_equal(sharded, single)
