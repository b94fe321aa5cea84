"""RTSTRUCT ingest + contour->mask->mesh pipeline tests
(BASELINE.json config #2)."""

import numpy as np
import pytest

import medicalimageanalysis_tpu as mia
from medicalimageanalysis_tpu.data import Data

from helpers import square_contour_mm, write_ct_series, write_rtstruct


@pytest.fixture
def ct_with_rtstruct(tmp_path, rng):
    arr = rng.integers(-1000, 2000, size=(12, 32, 32)).astype(np.int16)
    info = write_ct_series(tmp_path / "ct", arr)
    rois = {
        "Liver": [(square_contour_mm(info, z), z) for z in range(3, 8)],
        "Tumor": [(square_contour_mm(info, z, 8, 12), z)
                  for z in range(5, 7)],
    }
    pois = {"Marker": [-96.0, -116.0, -45.0]}
    write_rtstruct(tmp_path / "ct" / "rs.dcm", info, rois, pois)
    return tmp_path, info


def test_rtstruct_attached(ct_with_rtstruct):
    tmp_path, info = ct_with_rtstruct
    mia.read_dicoms(folder_path=str(tmp_path))
    img = Data.image["CT 01"]
    assert set(img.rois.keys()) == {"Liver", "Tumor"}
    assert set(img.pois.keys()) == {"Marker"}
    assert sorted(Data.roi_list) == ["Liver", "Tumor"]
    liver = img.rois["Liver"]
    assert len(liver.contour_position) == 5
    assert liver.color == [255, 0, 0]
    # pixel contours are closed (first point repeated)
    np.testing.assert_allclose(liver.contour_pixel[0][0],
                               liver.contour_pixel[0][-1])
    # poi position intact
    np.testing.assert_allclose(
        np.asarray(img.pois["Marker"].point_position).reshape(-1),
        [-96.0, -116.0, -45.0])


def test_roi_mask(ct_with_rtstruct):
    tmp_path, info = ct_with_rtstruct
    mia.read_dicoms(folder_path=str(tmp_path))
    img = Data.image["CT 01"]
    mask = img.rois["Liver"].compute_mask()
    assert mask.shape == (12, 32, 32)
    assert mask.dtype == np.uint8
    # square px 5..15 inclusive on slices 3..7
    expected = np.zeros((12, 32, 32), np.uint8)
    expected[3:8, 5:16, 5:16] = 1
    np.testing.assert_array_equal(mask, expected)


def test_mask_parity_cv2_backend(ct_with_rtstruct):
    tmp_path, info = ct_with_rtstruct
    mia.read_dicoms(folder_path=str(tmp_path))
    img = Data.image["CT 01"]
    roi = img.rois["Liver"]
    from medicalimageanalysis_tpu.utils.convert.contour import (
        ContourToDiscreteMesh)
    device = ContourToDiscreteMesh(
        contour_pixel=roi.contour_pixel, spacing=img.spacing,
        origin=img.origin, dimensions=img.dimensions, matrix=img.matrix,
        plane=roi.plane, backend="device").mask
    cv2m = ContourToDiscreteMesh(
        contour_pixel=roi.contour_pixel, spacing=img.spacing,
        origin=img.origin, dimensions=img.dimensions, matrix=img.matrix,
        plane=roi.plane, backend="cv2").mask
    np.testing.assert_array_equal(device, cv2m)


def test_only_load_roi_names(ct_with_rtstruct):
    tmp_path, info = ct_with_rtstruct
    mia.read_dicoms(folder_path=str(tmp_path),
                    only_load_roi_names=["Tumor"])
    img = Data.image["CT 01"]
    assert "Tumor" in img.rois
    assert "Liver" not in img.rois


def test_mask_to_contour_roundtrip(ct_with_rtstruct):
    tmp_path, info = ct_with_rtstruct
    mia.read_dicoms(folder_path=str(tmp_path))
    img = Data.image["CT 01"]
    roi = img.rois["Liver"]
    mask = roi.compute_mask()
    roi.convert_mask(mask)
    # round trip: contours regenerated, mask identical
    mask2 = roi.compute_mask()
    np.testing.assert_array_equal(mask, mask2)
    assert roi.mesh is not None
    assert roi.mesh.number_of_points > 0


def test_roi_mesh_volume(ct_with_rtstruct):
    """Mesh from an 11x11 px x 5 slice box: volume close to analytic."""
    tmp_path, info = ct_with_rtstruct
    mia.read_dicoms(folder_path=str(tmp_path))
    img = Data.image["CT 01"]
    roi = img.rois["Liver"]
    roi.create_discrete_mesh()
    # voxel volume: 11*11*0.8*0.8*... mask is 11x11 px * 5 slices
    voxel_vol = 0.8 * 0.8 * 2.5
    expected = 11 * 11 * 5 * voxel_vol
    # marching-cubes surface at 0.5 iso adds a half-voxel shell
    assert roi.volume == pytest.approx(expected, rel=0.25)
    assert roi.com is not None
    assert len(roi.bounds) == 6


def test_match_rois_injects_stubs(tmp_path, rng):
    arr = rng.integers(0, 100, size=(4, 16, 16)).astype(np.int16)
    info_a = write_ct_series(tmp_path / "a", arr)
    info_b = write_ct_series(tmp_path / "b", arr, modality="MR")
    rois = {"Liver": [(square_contour_mm(info_a, 1), 1)]}
    write_rtstruct(tmp_path / "a" / "rs.dcm", info_a, rois)
    mia.read_dicoms(folder_path=str(tmp_path))
    # both images must have a Liver roi (stub on the MR)
    names = [n for n in Data.image_list]
    assert len(names) == 2
    for n in names:
        assert "Liver" in Data.image[n].rois
    stubs = [Data.image[n].rois["Liver"].contour_position is None
             for n in names]
    assert sorted(stubs) == [False, True]


def test_compute_contour_slices(ct_with_rtstruct):
    tmp_path, info = ct_with_rtstruct
    mia.read_dicoms(folder_path=str(tmp_path))
    roi = Data.image["CT 01"].rois["Liver"]
    loops = roi.compute_contour(slice_location=4)
    assert len(loops) == 1
    assert loops[0].shape[1] == 2
    assert len(roi.compute_contour(slice_location=11)) == 0


def test_mask_contour_mask_invariance(tmp_path, rng):
    """Property test: mask -> traced contours -> re-rasterized mask stays
    within one morphological step of the original (both directions),
    for random blob masks."""
    from scipy import ndimage
    from medicalimageanalysis_tpu.utils.convert.contour import (
        MaskToContour, _rasterize_plane)

    for trial in range(5):
        r2 = np.random.default_rng(trial)
        mask = np.zeros((6, 40, 40), np.uint8)
        # random union of ellipses per slice
        for z in range(1, 5):
            yy, xx = np.mgrid[0:40, 0:40]
            for _ in range(r2.integers(1, 3)):
                cy, cx = r2.uniform(10, 30, 2)
                ry, rx = r2.uniform(4, 10, 2)
                mask[z] |= ((((yy - cy) / ry) ** 2
                             + ((xx - cx) / rx) ** 2) <= 1).astype(
                                 np.uint8)

        m2c = MaskToContour(mask, spacing=[1, 1, 1], origin=[0, 0, 0],
                            matrix=np.eye(3), plane="Axial")
        pixel_contours, _ = m2c.create_contours()
        if not pixel_contours:
            continue
        refilled = _rasterize_plane(pixel_contours, mask.shape, "Axial")

        grown = ndimage.binary_dilation(mask, np.ones((1, 3, 3)))
        shrunk = ndimage.binary_erosion(mask, np.ones((1, 3, 3)))
        # refilled within [eroded, dilated] envelope of the original
        assert (refilled.astype(bool) <= grown).all(), trial
        assert (shrunk <= refilled.astype(bool)).all(), trial


def test_match_rois_color_propagation(tmp_path, rng):
    arr = rng.integers(0, 100, size=(3, 12, 12)).astype(np.int16)
    info_a = write_ct_series(tmp_path / "a", arr)
    write_ct_series(tmp_path / "b", arr, modality="MR")
    rois = {"Heart": [(square_contour_mm(info_a, 1, 2, 8), 1)]}
    write_rtstruct(tmp_path / "a" / "rs.dcm", info_a, rois)
    mia.read_dicoms(folder_path=str(tmp_path))
    mr = [n for n in Data.image_list
          if Data.image[n].modality == "MR"][0]
    stub = Data.image[mr].rois["Heart"]
    # authoritative color [255, 0, 0] propagated to the stub
    assert list(stub.color) == [255, 0, 0]
    assert stub.contour_position is None


def test_raster_backend_auto_selection(monkeypatch):
    """backend='auto' (the default) takes the device rasterizer on an
    accelerator, so the main path needs no cv2; on the CPU backend it
    takes cv2 when cv2 is installed and the device path otherwise."""
    import importlib.util

    import jax

    from medicalimageanalysis_tpu.utils.convert.contour import (
        _pick_raster_backend)

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    assert _pick_raster_backend() == "device"
    monkeypatch.setattr(jax, "default_backend", lambda: "cpu")
    have_cv2 = importlib.util.find_spec("cv2") is not None
    assert _pick_raster_backend() == ("cv2" if have_cv2 else "device")
    monkeypatch.setattr(importlib.util, "find_spec", lambda name: None)
    assert _pick_raster_backend() == "device"


def test_compute_roi_masks_pooled_matches_per_roi(tmp_path, rng):
    """Image.compute_roi_masks: the whole structure set in one pooled
    device pass, bit-identical to per-ROI compute_mask; stub ROIs
    (match_rois injections, no contours) come back all-zero."""
    from helpers import square_contour_mm, write_ct_series, write_rtstruct

    arr = rng.integers(-500, 500, size=(8, 24, 24)).astype(np.int16)
    info = write_ct_series(tmp_path / "ct", arr, spacing=(1, 1),
                           thickness=2.0)
    rois = {
        "Target": [(square_contour_mm(info, z, 6, 14), z)
                   for z in range(2, 6)],
        "Node": [(square_contour_mm(info, z, 3, 8), z)
                 for z in range(1, 4)],
        "Skin": [(square_contour_mm(info, z, 1, 22), z)
                 for z in range(0, 8)],
    }
    write_rtstruct(tmp_path / "ct" / "rs.dcm", info, rois)
    mia.read_dicoms(folder_path=str(tmp_path))
    img = Data.image["CT 01"]
    img.create_roi(name="Stub", color=[1, 2, 3])  # no contours

    pooled = img.compute_roi_masks()
    assert set(pooled) == {"Target", "Node", "Skin", "Stub"}
    for name in ("Target", "Node", "Skin"):
        np.testing.assert_array_equal(
            pooled[name],
            np.asarray(img.rois[name].compute_mask()).astype(np.uint8),
            err_msg=name)
        assert pooled[name].sum() > 0
    assert pooled["Stub"].sum() == 0

    sub = img.compute_roi_masks(["Node"])
    np.testing.assert_array_equal(sub["Node"], pooled["Node"])

    # the pooled-device branch stays bit-identical when the link-rate
    # gate picks it (on CPU the gate picks cv2, so force it)
    import medicalimageanalysis_tpu.utils.convert.contour as contour_mod
    orig = contour_mod._pick_raster_backend
    contour_mod._pick_raster_backend = lambda *a, **k: "device"
    try:
        img._roi_mask_cache.clear()   # force a real device pass
        forced = img.compute_roi_masks()
    finally:
        contour_mod._pick_raster_backend = orig
    for name in ("Target", "Node", "Skin", "Stub"):
        np.testing.assert_array_equal(forced[name], pooled[name],
                                      err_msg=name)


def test_roi_mask_cache_pooled_and_invalidation(tmp_path, rng):
    """VERDICT r4 #3: the first Roi.compute_mask on a multi-ROI image
    triggers ONE pooled pass that fills the per-image cache; later
    calls are served from it (no re-rasterization), and any
    contour/mesh rebind or Roi replacement invalidates the entry."""
    from helpers import square_contour_mm, write_ct_series, write_rtstruct

    arr = rng.integers(-500, 500, size=(8, 24, 24)).astype(np.int16)
    info = write_ct_series(tmp_path / "ct", arr, spacing=(1, 1),
                           thickness=2.0)
    rois = {
        "A": [(square_contour_mm(info, z, 6, 14), z)
              for z in range(2, 6)],
        "B": [(square_contour_mm(info, z, 3, 8), z)
              for z in range(1, 4)],
    }
    write_rtstruct(tmp_path / "ct" / "rs.dcm", info, rois)
    mia.read_dicoms(folder_path=str(tmp_path))
    img = Data.image["CT 01"]

    import medicalimageanalysis_tpu.structure.roi as roi_mod
    calls = {"n": 0}
    orig_impl = roi_mod.Roi._compute_mask_impl

    def counting_impl(self):
        calls["n"] += 1
        return orig_impl(self)

    roi_mod.Roi._compute_mask_impl = counting_impl
    try:
        a1 = img.rois["A"].compute_mask()
        first = calls["n"]
        # pooled fill: B is already cached, its first call is free
        b1 = img.rois["B"].compute_mask()
        a2 = img.rois["A"].compute_mask()
        assert calls["n"] == first, "cached calls re-rasterized"
        np.testing.assert_array_equal(a1, a2)

        # cached copies are fresh arrays — caller mutation is safe
        a2[:] = 9
        np.testing.assert_array_equal(img.rois["A"].compute_mask(), a1)

        # contour rebind invalidates exactly that ROI
        img.rois["B"].update_pixel(
            [c + np.array([1.0, 1.0, 0.0]) for c in
             img.rois["B"].contour_pixel], plane="Axial")
        before = calls["n"]
        b2 = img.rois["B"].compute_mask()
        assert calls["n"] > before, "stale mask served after edit"
        assert not np.array_equal(b1, b2)

        # wholesale Roi replacement (same name) invalidates too
        img.add_roi(roi_name="A", color=[1, 2, 3], contour=None)
        a3 = img.rois["A"].compute_mask()
        assert a3.sum() == 0
    finally:
        roi_mod.Roi._compute_mask_impl = orig_impl

    # pooled pass and per-ROI path stay bit-identical post-cache
    img._roi_mask_cache.clear()
    pooled = img.compute_roi_masks()
    np.testing.assert_array_equal(pooled["B"],
                                  img.rois["B"].compute_mask())

def test_roi_mask_cache_survives_id_reuse(tmp_path, rng):
    """Cache keys must NOT be id()-based: CPython reuses a freed Roi's
    address, and a replacement Roi built from fresh contours lands on
    the same deterministic _mask_rev, so an id()-keyed cache would
    serve the DELETED ROI's mask for the new one. Keys use a
    process-global monotonic token instead — never reused."""
    from medicalimageanalysis_tpu.structure.roi import Roi

    arr = rng.integers(-500, 500, size=(8, 24, 24)).astype(np.int16)
    info = write_ct_series(tmp_path / "ct", arr, spacing=(1, 1),
                           thickness=2.0)
    rois = {"A": [(square_contour_mm(info, z, 6, 14), z)
                  for z in range(2, 6)]}
    write_rtstruct(tmp_path / "ct" / "rs.dcm", info, rois)
    mia.read_dicoms(folder_path=str(tmp_path))
    img = Data.image["CT 01"]

    old_mask = np.asarray(img.rois["A"].compute_mask())
    assert old_mask.sum() > 0
    base = [c.copy() for c in img.rois["A"].contour_pixel]

    # tokens are unique across object lifetimes even when id() collides;
    # geometry toggles between two fixed shapes so consecutive
    # replacements ALWAYS have different true masks
    seen_tokens = set()
    for i in range(30):
        old = img.rois.pop("A")
        del old  # freed — its address is now reusable
        repl = Roi(img, name="A")
        shift = 3.0 if i % 2 == 0 else 0.0
        repl.contour_pixel = [c + np.array([0.0, shift, 0.0])
                              for c in base]
        img.rois["A"] = repl
        new_mask = np.asarray(repl.compute_mask())
        assert new_mask.sum() > 0
        assert not np.array_equal(new_mask, old_mask), \
            "stale cached mask served for a replacement Roi"
        seen_tokens.add(img._roi_cache_key(repl)[0])
        old_mask = new_mask
    assert len(seen_tokens) == 30, "cache tokens were reused"


def test_compute_mask_pools_only_contoured_group(tmp_path, rng):
    """Roi.compute_mask's pooled trigger must scope the pooled pass to
    the CONTOURED uncached ROIs + itself: an unconstrained
    compute_roi_masks() would also voxelize every mesh-only ROI on the
    image (~100+ ms each) the caller never asked about."""
    arr = rng.integers(-500, 500, size=(8, 24, 24)).astype(np.int16)
    info = write_ct_series(tmp_path / "ct", arr, spacing=(1, 1),
                           thickness=2.0)
    rois = {
        "A": [(square_contour_mm(info, z, 6, 14), z)
              for z in range(2, 6)],
        "B": [(square_contour_mm(info, z, 3, 8), z)
              for z in range(1, 4)],
    }
    write_rtstruct(tmp_path / "ct" / "rs.dcm", info, rois)
    mia.read_dicoms(folder_path=str(tmp_path))
    img = Data.image["CT 01"]

    # a mesh-only ROI: expensive to voxelize, must stay untouched
    img.create_roi(name="Contoured0", color=[0, 0, 255])
    zz, yy, xx = np.mgrid[0:8, 0:24, 0:24]
    sphere = ((zz - 4) ** 2 + ((yy - 12) / 2.0) ** 2
              + ((xx - 12) / 2.0) ** 2) <= 6
    img.create_roi(name="SphereSrc", color=[0, 255, 0])
    img.rois["SphereSrc"].convert_mask(sphere)
    img.rois["SphereSrc"].create_discrete_mesh()
    img.create_roi(name="MeshOnly", color=[255, 0, 0])
    img.rois["MeshOnly"].update_mesh(img.rois["SphereSrc"].mesh)
    img.rois.pop("SphereSrc")
    img.rois.pop("Contoured0")
    if getattr(img, "_roi_mask_cache", None):
        img._roi_mask_cache.clear()

    import medicalimageanalysis_tpu.structure.roi as roi_mod
    voxelized = []
    orig = roi_mod.Roi._mask_from_mesh

    def counting(self):
        voxelized.append(self.name)
        return orig(self)

    roi_mod.Roi._mask_from_mesh = counting
    try:
        a = img.rois["A"].compute_mask()   # pools A + B, NOT MeshOnly
        b = img.rois["B"].compute_mask()   # cache hit
        assert voxelized == [], \
            f"pooled pass voxelized mesh-only ROIs: {voxelized}"
        assert a.sum() > 0 and b.sum() > 0
        # the mesh-only ROI still works when actually requested
        m = img.rois["MeshOnly"].compute_mask()
        assert voxelized == ["MeshOnly"] and m.sum() > 0
    finally:
        roi_mod.Roi._mask_from_mesh = orig
