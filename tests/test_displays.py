"""Display-state interplay tests: rigid/deformable/dose views, MHD DVF
branch, cumulative DVH counts."""

import numpy as np
import pytest

import medicalimageanalysis_tpu as mia
from medicalimageanalysis_tpu.data import Data

from helpers import write_ct_series


@pytest.fixture
def pair(tmp_path, rng):
    zz, yy, xx = np.mgrid[0:8, 0:24, 0:24]
    base = (500 * np.exp(-(((zz - 4) / 2.0) ** 2 + ((yy - 12) / 5.0) ** 2
                           + ((xx - 12) / 5.0) ** 2))).astype(np.int16)
    write_ct_series(tmp_path / "a", base, spacing=(1, 1), thickness=2.0)
    write_ct_series(tmp_path / "b", np.roll(base, 2, axis=2),
                    spacing=(1, 1), thickness=2.0, modality="MR")
    mia.read_dicoms(folder_path=str(tmp_path))
    names = sorted(Data.image_list)
    ct = [n for n in names if Data.image[n].modality == "CT"][0]
    mr = [n for n in names if Data.image[n].modality == "MR"][0]
    return ct, mr


def test_rigid_display_sync(pair):
    ct, mr = pair
    rigid = mia.Rigid(ct, mr)
    sl = rigid.retrieve_array_plane("Axial")
    assert sl is not None and sl.ndim == 2
    # slice location derived from reference image display state
    assert rigid.retrieve_scroll_max("Axial") \
        == rigid.display.array.shape[0] - 1
    offset = rigid.retrieve_offset("Axial")
    assert len(offset) == 2
    pos = rigid.retrieve_slice_position("Axial")
    assert pos.shape == (3,)


def test_rigid_mesh_slice(pair, tmp_path):
    ct, mr = pair
    # give the moving image a visible ROI mesh
    img = Data.image[mr]
    mask = np.zeros(img.array.shape, np.uint8)
    mask[2:6, 8:16, 8:16] = 1
    img.add_roi(roi_name="Cube", color=[255, 0, 0], visible=True)
    img.rois["Cube"].convert_mask(mask)
    img.rois["Cube"].visible = True

    rigid = mia.Rigid(ct, mr)
    rigid.retrieve_array_plane("Axial")  # populate display state first
    rigid.update_rois()
    assert rigid.rois["Cube"] is not None
    loops = rigid.display.compute_mesh_slice(
        roi_name="Cube", location=rigid.rois["Cube"].center,
        slice_plane="Axial", return_pixel=True)
    assert len(loops) >= 1


def test_deformable_mesh_warp(pair):
    ct, mr = pair
    img = Data.image[mr]
    mask = np.zeros(img.array.shape, np.uint8)
    mask[2:6, 8:16, 8:16] = 1
    img.add_roi(roi_name="Cube", color=[0, 255, 0], visible=True)
    img.rois["Cube"].convert_mask(mask)
    img.rois["Cube"].visible = True

    deform = mia.Deformable(reference_name=ct, moving_name=mr,
                            roi_names=[])
    deform.compute_demons(modality_gradient=False, iterations=15, crop=0)
    deform.update_rois()
    warped = deform.rois["Cube"]
    assert warped is not None
    orig = img.rois["Cube"].mesh
    # mesh moved but stayed in the neighborhood
    delta = np.abs(warped.points - orig.points).max()
    assert 0 < delta < 10


def test_mhd_dvf_branch(pair, tmp_path, rng):
    ct, mr = pair
    from medicalimageanalysis_tpu.read.mhd import write_mhd_volume
    dvf = rng.normal(0, 0.5, size=(8, 24, 24, 3)).astype(np.float32)
    write_mhd_volume(tmp_path / "dvf.mhd", dvf, spacing=[1, 1, 2],
                     origin=[-100, -120, -50])
    mia.read_mhd(file=str(tmp_path / "dvf.mhd"), reference_name=ct,
                 moving_name=mr, dvf=True)
    assert Data.deformable_list == [f"DVF_{ct}_{mr}"]
    deform = Data.deformable[Data.deformable_list[0]]
    assert deform.dvf.shape == (8, 24, 24, 3)


def test_dose_display(tmp_path, rng, pair):
    ct, mr = pair
    from test_deformable_dose import write_rtdose_file
    info = {"origin": Data.image[ct].origin,
            "spacing": Data.image[ct].spacing[:2],
            "thickness": Data.image[ct].spacing[2],
            "frame": "1.2.3"}
    dose_raw = np.full((8, 24, 24), 30000, np.uint32)
    write_rtdose_file(tmp_path / "rd.dcm", dose_raw, info)
    mia.read_dicoms(file_list=[str(tmp_path / "rd.dcm")], clear=False)
    dose = Data.dose["RTDOSE 01"]
    sl = dose.retrieve_array_plane("Axial")
    assert sl.shape == (24, 24)
    np.testing.assert_allclose(sl, 30.0, atol=1e-3)
    assert dose.compute_aspect("Axial") == 1.0


def test_pallas_histogram_interpret(rng):
    """The cumulative DVH counts (dose < t among valid voxels) match a
    numpy count exactly."""
    from medicalimageanalysis_tpu.ops.dvh import count_below
    dose = rng.uniform(0, 60, 3000).astype(np.float32)
    valid = (rng.uniform(size=3000) > 0.5).astype(np.float32)
    thr = np.arange(0, 60, 10, dtype=np.float32)
    out = np.asarray(count_below(dose, thr, valid))
    gold = np.array([np.sum((dose < t) & (valid > 0)) for t in thr])
    np.testing.assert_array_equal(out, gold)
