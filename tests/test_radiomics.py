"""Radiomics panel vs brute-force numpy twins.

The device texture-matrix kernels (one-hot matmul counting, log-doubling
run lengths, 26-stencil dependence/gray-tone difference) are verified
against direct per-voxel Python counting on small random volumes —
the 'golden numpy twin' pattern used across the suite.
"""

import numpy as np
import pytest

from medicalimageanalysis_tpu.ops import radiomics as R


@pytest.fixture
def rng():
    return np.random.default_rng(7)


def _small(rng, shape=(7, 8, 6), ng=5, p=0.7):
    lev = rng.integers(0, ng, size=shape).astype(np.int32)
    mask = rng.random(shape) < p
    mask[0, 0, 0] = True  # never fully empty
    return lev, mask, ng


def _in(shape, v):
    return all(0 <= v[k] < shape[k] for k in range(3))


def brute_glcm(lev, mask, ng, d):
    P = np.zeros((ng, ng))
    Z, Y, X = lev.shape
    for z in range(Z):
        for y in range(Y):
            for x in range(X):
                v = (z, y, x)
                u = (z - d[0], y - d[1], x - d[2])
                if mask[v] and _in(lev.shape, u) and mask[u]:
                    P[lev[v], lev[u]] += 1
    return P + P.T


def brute_glrlm(lev, mask, ng, d, lmax):
    P = np.zeros((ng, lmax))
    Z, Y, X = lev.shape
    for z in range(Z):
        for y in range(Y):
            for x in range(X):
                v = (z, y, x)
                if not mask[v]:
                    continue
                u = (z - d[0], y - d[1], x - d[2])
                if _in(lev.shape, u) and mask[u] and lev[u] == lev[v]:
                    continue  # not a run start
                length = 1
                w = (z + d[0], y + d[1], x + d[2])
                while (_in(lev.shape, w) and mask[w]
                       and lev[w] == lev[v]):
                    length += 1
                    w = (w[0] + d[0], w[1] + d[1], w[2] + d[2])
                P[lev[v], length - 1] += 1
    return P


def brute_gldm_ngtdm(lev, mask, ng, alpha=0):
    gldm = np.zeros((ng, 27))
    s = np.zeros(ng)
    n = np.zeros(ng)
    Z, Y, X = lev.shape
    offs = [(a, b, c) for a in (-1, 0, 1) for b in (-1, 0, 1)
            for c in (-1, 0, 1) if a or b or c]
    for z in range(Z):
        for y in range(Y):
            for x in range(X):
                if not mask[z, y, x]:
                    continue
                dep = 0
                vals = []
                for d in offs:
                    u = (z + d[0], y + d[1], x + d[2])
                    if _in(lev.shape, u) and mask[u]:
                        vals.append(lev[u] + 1)
                        if abs(int(lev[u]) - int(lev[z, y, x])) <= alpha:
                            dep += 1
                gldm[lev[z, y, x], dep] += 1
                if vals:
                    abar = np.mean(vals)
                    s[lev[z, y, x]] += abs(lev[z, y, x] + 1 - abar)
                    n[lev[z, y, x]] += 1
    return gldm, s, n


def test_glcm_glrlm_match_bruteforce(rng):
    lev, mask, ng = _small(rng)
    lmax = max(lev.shape)
    mats = R.texture_matrices(lev, mask, ng, Lmax=lmax)
    for k, d in enumerate(R.DIRECTIONS_13):
        np.testing.assert_allclose(
            mats["glcm"][k], brute_glcm(lev, mask, ng, d), atol=0,
            err_msg=f"glcm direction {d}")
        np.testing.assert_allclose(
            mats["glrlm"][k], brute_glrlm(lev, mask, ng, d, lmax),
            atol=0, err_msg=f"glrlm direction {d}")
    # run-length conservation: every ROI voxel is in exactly one run
    lengths = np.arange(1, lmax + 1)
    for k in range(len(R.DIRECTIONS_13)):
        assert mats["glrlm"][k].sum(axis=0) @ lengths == mask.sum()


def test_gldm_ngtdm_match_bruteforce(rng):
    lev, mask, ng = _small(rng, shape=(6, 7, 5))
    mats = R.texture_matrices(lev, mask, ng)
    gldm, s, n = brute_gldm_ngtdm(lev, mask, ng)
    np.testing.assert_allclose(mats["gldm"], gldm, atol=0)
    np.testing.assert_allclose(mats["ngtdm_n"], n, atol=0)
    np.testing.assert_allclose(mats["ngtdm_s"], s, rtol=0, atol=1e-4)
    np.testing.assert_allclose(
        mats["hist"],
        np.bincount(lev[mask], minlength=ng).astype(float), atol=0)
    # alpha widens dependence
    mats1 = R.texture_matrices(lev, mask, ng, alpha=1)
    gldm1, _, _ = brute_gldm_ngtdm(lev, mask, ng, alpha=1)
    np.testing.assert_allclose(mats1["gldm"], gldm1, atol=0)


def test_glcm_features_tiny_handcase():
    # two voxels level 0, one level 1 along +x, full mask: pairs along
    # (0,0,1): (0,0)+(0,1) ordered -> symmetric counts
    lev = np.array([[[0, 0, 1]]], np.int32)
    mask = np.ones_like(lev, bool)
    mats = R.texture_matrices(lev, mask, 2, Lmax=3)
    gx = mats["glcm"][0]  # direction (0, 0, 1)
    np.testing.assert_allclose(gx, [[2, 1], [1, 0]])
    f = R.glcm_features(gx)
    # P normalized: p(0,0)=.5, p(0,1)=p(1,0)=.25
    assert f["JointEnergy"] == pytest.approx(0.375)
    assert f["Contrast"] == pytest.approx(0.5)
    assert f["MaximumProbability"] == pytest.approx(0.5)
    # run lengths along x: [0,0] run of 2, [1] run of 1
    grl = mats["glrlm"][0]
    np.testing.assert_allclose(grl, [[0, 1, 0], [1, 0, 0]])
    f = R.glrlm_features(grl[None], n_vox=3)
    assert f["RunPercentage"] == pytest.approx(2.0 / 3.0)
    assert f["LongRunEmphasis"] == pytest.approx((4 + 1) / 2)


def test_glszm_handcase():
    lev = np.zeros((2, 3, 3), np.int32)
    lev[0, 0, :] = 1          # one 3-voxel zone of level 1
    lev[1, 2, 2] = 1          # isolated (not 26-connected to above)
    mask = np.ones_like(lev, bool)
    P = R.glszm_matrix(lev, mask, 2)
    # level 0: one 26-connected zone of the remaining 14 voxels
    assert P[0, 13] == 1
    assert P[1, 2] == 1 and P[1, 0] == 1
    f = R.glszm_features(P, n_vox=18)
    assert f["ZonePercentage"] == pytest.approx(3 / 18)


def test_first_order_matches_numpy(rng):
    vals = rng.normal(100.0, 25.0, size=(6, 7, 8))
    mask = rng.random(vals.shape) > 0.4
    sp = [0.9, 1.1, 2.0]
    f = R.first_order_features(vals, mask, sp)
    x = vals[mask]
    assert f["Mean"] == pytest.approx(x.mean())
    assert f["Variance"] == pytest.approx(x.var())
    assert f["Energy"] == pytest.approx(np.sum(x * x))
    assert f["TotalEnergy"] == pytest.approx(
        np.prod(sp) * np.sum(x * x))
    assert f["RootMeanSquared"] == pytest.approx(
        np.sqrt(np.mean(x * x)))
    from scipy import stats
    assert f["Skewness"] == pytest.approx(stats.skew(x), abs=1e-9)
    assert f["Kurtosis"] == pytest.approx(
        stats.kurtosis(x, fisher=False), abs=1e-9)
    assert f["InterquartileRange"] == pytest.approx(
        np.percentile(x, 75) - np.percentile(x, 25))
    p10, p90 = np.percentile(x, [10, 90])
    rob = x[(x >= p10) & (x <= p90)]
    assert f["RobustMeanAbsoluteDeviation"] == pytest.approx(
        np.mean(np.abs(rob - rob.mean())))


def test_shape_features_sphere():
    r_mm = 9.0
    sp = [1.0, 1.0, 1.0]
    zz, yy, xx = np.mgrid[0:24, 0:24, 0:24]
    mask = ((zz - 12.0) ** 2 + (yy - 12.0) ** 2
            + (xx - 12.0) ** 2) <= r_mm ** 2
    f = R.shape_features(mask, sp)
    v_true = 4.0 / 3.0 * np.pi * r_mm ** 3
    assert f["MeshVolume"] == pytest.approx(v_true, rel=0.05)
    assert f["VoxelVolume"] == pytest.approx(v_true, rel=0.05)
    # a voxelized sphere's marching-cubes surface is a staircase —
    # its area exceeds the smooth 4*pi*r^2, so sphericity sits well
    # below 1 (pyradiomics behaves the same on binary spheres)
    assert 0.7 < f["Sphericity"] < 1.0
    assert f["Maximum3DDiameter"] == pytest.approx(2 * r_mm, rel=0.08)
    assert f["Maximum2DDiameterSlice"] == pytest.approx(2 * r_mm,
                                                        rel=0.08)
    assert f["Elongation"] == pytest.approx(1.0, abs=0.05)
    assert f["Flatness"] == pytest.approx(1.0, abs=0.05)
    # anisotropic stretch shows in the axis ordering
    f2 = R.shape_features(mask, [1.0, 1.0, 3.0])
    assert f2["MajorAxisLength"] > f2["LeastAxisLength"] * 2.0


def test_discretize_conventions():
    vals = np.array([[[-100.0, -75.0, 0.0, 24.9, 25.0, 80.0]]])
    mask = np.ones(vals.shape, bool)
    lev, ng = R.discretize(vals, mask, bin_width=25.0)
    np.testing.assert_array_equal(lev[0, 0], [0, 1, 4, 4, 5, 7])
    assert ng == 8
    lev, ng = R.discretize(vals, mask, n_bins=4)
    assert lev.min() == 0 and lev.max() == 3 and ng == 4
    # constant ROI collapses to one level
    lev, ng = R.discretize(np.full((2, 2, 2), 5.0),
                           np.ones((2, 2, 2), bool), n_bins=16)
    assert ng == 1 and lev.max() == 0
    with pytest.raises(ValueError):
        R.discretize(vals, mask)
    with pytest.raises(ValueError):
        R.discretize(vals, mask, bin_width=1, n_bins=2)


def test_compute_radiomics_end_to_end(rng):
    vol = rng.normal(0.0, 40.0, size=(12, 16, 14)).astype(np.float32)
    zz, yy, xx = np.mgrid[0:12, 0:16, 0:14]
    mask = ((zz - 6.0) ** 2 / 9 + (yy - 8.0) ** 2 / 25
            + (xx - 7.0) ** 2 / 16) <= 1.0
    vol[mask] += 120.0
    out = R.compute_radiomics(vol, mask, [1.0, 1.0, 2.5],
                              bin_width=25.0)
    assert set(out) == {"firstorder", "shape", "glcm", "glrlm",
                        "glszm", "gldm", "ngtdm", "meta"}
    for fam, feats in out.items():
        if fam == "meta":
            continue
        for k, v in feats.items():
            assert np.isfinite(v), (fam, k, v)
    assert out["meta"]["voxels"] == int(mask.sum())
    assert out["firstorder"]["Mean"] == pytest.approx(
        float(vol[mask].mean()), rel=1e-6)
    # empty mask -> NaN panels with the same schema
    empty = R.compute_radiomics(vol, np.zeros_like(mask),
                                [1, 1, 1], n_bins=8)
    assert all(np.isnan(v) for v in empty["glcm"].values())
    assert all(np.isnan(v) for v in empty["firstorder"].values())
    assert empty["meta"]["voxels"] == 0
    # family selection
    sub = R.compute_radiomics(vol, mask, [1, 1, 1], n_bins=8,
                              families=("firstorder",))
    assert set(sub) == {"firstorder", "meta"}


def test_radiomics_batch_matches_single(rng):
    import jax

    from medicalimageanalysis_tpu.parallel.batch import radiomics_batch
    from medicalimageanalysis_tpu.parallel.mesh import make_mesh

    B, shape, sp = 8, (9, 11, 10), (1.0, 1.2, 2.0)
    vols = rng.normal(0, 50, size=(B,) + shape).astype(np.float32)
    masks = np.stack([rng.random(shape) < (0.4 + 0.05 * b)
                      for b in range(B)])
    masks[:, 0, 0, 0] = True
    out = radiomics_batch(vols, masks, sp, n_bins=6)
    assert len(out) == B
    for b in range(B):
        single = R.compute_radiomics(vols[b], masks[b], sp, n_bins=6)
        for fam in ("firstorder", "glcm", "glrlm", "glszm", "gldm",
                    "ngtdm", "shape"):
            for k, v in single[fam].items():
                assert out[b][fam][k] == pytest.approx(
                    v, rel=1e-6, abs=1e-9), (b, fam, k)
        assert out[b]["meta"]["Ng"] == single["meta"]["Ng"]
    if len(jax.devices()) >= 8:
        sharded = radiomics_batch(vols, masks, sp, n_bins=6,
                                  families=("glcm", "ngtdm"),
                                  mesh=make_mesh(8, space=1))
        for b in range(B):
            for k, v in out[b]["glcm"].items():
                assert sharded[b]["glcm"][k] == pytest.approx(
                    v, rel=1e-6, abs=1e-9)
    with pytest.raises(ValueError):
        radiomics_batch(vols[:, 0], masks[:, 0], sp)


def test_image_compute_radiomics_api(tmp_path, rng):
    import medicalimageanalysis_tpu as mia
    from helpers import write_ct_series
    from medicalimageanalysis_tpu.data import Data

    zz, yy, xx = np.mgrid[0:8, 0:24, 0:24]
    base = (400 * np.exp(-(((zz - 4) / 2.0) ** 2
                           + ((yy - 12) / 5.0) ** 2
                           + ((xx - 12) / 5.0) ** 2))).astype(np.int16)
    write_ct_series(tmp_path / "a", base, spacing=(1, 1), thickness=2.0)
    mia.read_dicoms(folder_path=str(tmp_path))
    img = Data.image[Data.image_list[0]]
    mask = np.zeros(img.array.shape, np.uint8)
    mask[2:6, 8:16, 8:16] = 1
    img.add_roi(roi_name="Cube", color=[255, 0, 0], visible=True)
    img.rois["Cube"].convert_mask(mask)
    out = img.compute_radiomics("Cube", bin_width=50.0)
    assert out["meta"]["ROI"] == "Cube"
    roi_mask = np.asarray(img.rois["Cube"].compute_mask()) > 0
    assert out["meta"]["voxels"] == int(roi_mask.sum())
    assert out["firstorder"]["Mean"] == pytest.approx(
        float(np.asarray(img.array, np.float32)[roi_mask].mean()),
        rel=1e-6)
    assert np.isfinite(out["glcm"]["Contrast"])
    assert np.isfinite(out["shape"]["MeshVolume"])
    with pytest.raises(ValueError):
        img.compute_radiomics("Cube", values=np.zeros((2, 2, 2)))
    Data.clear()
