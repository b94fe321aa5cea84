"""Adaptive-radiotherapy walkthrough: SEG ingest, deformable dose
accumulation, DICOM export.

The workflow the reference cannot express (it reads RTSTRUCT/RTDOSE
but has no SEG support, no dose warping, and no DICOM writers):

1. planning CT + auto-segmentation as a DICOM SEG object
2. fraction image (anatomy shifted) + fraction RTDOSE on its grid
3. demons deformable registration fraction -> planning
4. Deformable.update_dose warps the fraction dose onto the planning
   grid (ops/warp.py); accumulate_dose sums the
   plan + warped fraction as a first-class Dose
5. DVH statistics on the accumulated dose over the SEG-derived ROI
6. export: accumulated dose as RTDOSE, contours as RTSTRUCT + SEG

Run: python examples/adaptive_rt.py   (CPU or GPU)
"""

import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import medicalimageanalysis_tpu as mia
from medicalimageanalysis_tpu.data import Data
from medicalimageanalysis_tpu.utils import accumulate_dose
from medicalimageanalysis_tpu.utils.creation import CreateDicomImage


def make_anatomy(shift=0):
    zz, yy, xx = np.mgrid[0:16, 0:48, 0:48]
    body = 1000 * np.exp(-(((zz - 8) / 6.0) ** 2
                           + ((yy - 24) / 14.0) ** 2
                           + ((xx - 24 - shift) / 14.0) ** 2)) - 1000
    return body.astype(np.int16)


def main():
    tmp = tempfile.mkdtemp(prefix="mia_art_")

    # -- 1. planning CT + SEG ------------------------------------------------
    CreateDicomImage(os.path.join(tmp, "plan_ct"), make_anatomy(0),
                     origin=[-100, -100, -40], spacing=[1.0, 1.0],
                     thickness=2.0).run(patient_name="ART^Demo")
    mia.read_dicoms(folder_path=os.path.join(tmp, "plan_ct"))
    plan_ct = Data.image_list[0]
    img = Data.image[plan_ct]

    target = np.zeros((16, 48, 48), np.uint8)
    target[5:11, 16:33, 16:33] = 1
    img.create_roi(name="GTV", color=[255, 40, 40])
    img.rois["GTV"].convert_mask(target)
    seg_path = os.path.join(tmp, "plan_ct", "seg.dcm")
    img.create_seg(path=seg_path)
    print("wrote SEG:", seg_path)

    # -- 2. fraction image (anatomy shifted 3 px in x) + fraction dose ------
    fx_gen = CreateDicomImage(os.path.join(tmp, "fx_ct"),
                              make_anatomy(3),
                              origin=[-100, -100, -40],
                              spacing=[1.0, 1.0], thickness=2.0)
    fx_gen.run(modality="MR")

    # fraction dose painted on the fraction grid (covers shifted GTV),
    # staged as a real RTDOSE file tied to the fraction frame
    from medicalimageanalysis_tpu.dicom import (Dataset, dcmwrite,
                                                generate_uid, uids)
    fx_dose = np.zeros((16, 48, 48), np.float32)
    fx_dose[5:11, 16:33, 19:36] = 2.0   # 2 Gy fraction
    ds = Dataset()
    ds.SOPClassUID = uids.RTDoseStorage
    ds.SOPInstanceUID = generate_uid()
    ds.Modality = "RTDOSE"
    ds.FrameOfReferenceUID = fx_gen.frame
    ds.ImagePositionPatient = [-100.0, -100.0, -40.0]
    ds.ImageOrientationPatient = [1, 0, 0, 0, 1, 0]
    ds.PixelSpacing = [1.0, 1.0]
    ds.SliceThickness = 2.0
    ds.GridFrameOffsetVector = [2.0 * i for i in range(16)]
    ds.DoseGridScaling = 1e-3
    ds.DoseUnits = "GY"
    ds.DoseType = "PHYSICAL"
    ds.DoseSummationType = "FRACTION"
    ds.NumberOfFrames, ds.Rows, ds.Columns = 16, 48, 48
    ds.BitsAllocated = ds.BitsStored = 32
    ds.HighBit = 31
    ds.PixelRepresentation = 0
    ds.SamplesPerPixel = 1
    ds.PhotometricInterpretation = "MONOCHROME2"
    ds.PixelData = np.round(fx_dose / 1e-3).astype("<u4").tobytes()
    dcmwrite(os.path.join(tmp, "fx_ct", "rd_fx.dcm"), ds)

    # -- one combined ingest: plan CT + SEG + fraction MR + fraction dose ---
    Data.clear()
    mia.read_dicoms(folder_path=tmp)
    plan_ct = [n for n in Data.image_list
               if Data.image[n].modality == "CT"][0]
    img = Data.image[plan_ct]
    assert "GTV" in img.rois, "SEG did not round-trip"
    print("SEG ingested from disk, ROIs:", list(img.rois))
    fx_name = [n for n in Data.image_list
               if Data.image[n].modality == "MR"][0]
    fx_dose_name = Data.dose_list[0]
    print("fraction dose:", fx_dose_name)

    # -- 3. deformable registration fraction -> planning --------------------
    deform = mia.Deformable(reference_name=plan_ct, moving_name=fx_name,
                            roi_names=[])
    deform.compute_demons(method="demons", modality_gradient=False,
                          iterations=60, crop=0)
    print("demons field:", deform.dvf.shape)

    # -- 4. warp fraction dose + accumulate on the planning grid ------------
    acc = accumulate_dose(
        plan_ct, [(fx_dose_name, deform.deformable_name)],
        weights=[30.0],             # 30 identical fractions
        name="Accumulated")
    print("accumulated dose:", acc.dose_name,
          "max %.2f Gy" % float(np.asarray(acc.array).max()))

    # -- 5. DVH on the SEG-derived ROI ---------------------------------------
    stats = acc.compute_roi_dose_statistics(plan_ct, "GTV")
    print("GTV DVH:", {k: (round(v, 2) if isinstance(v, float) else v)
                       for k, v in stats.items()
                       if k in ("ROI", "Volume (cc)", "Dmin", "Dmax",
                                "Dmean", "D95")})
    bins, vol_pct = acc.compute_dvh_curve(plan_ct, "GTV")
    print("DVH curve points:", len(bins),
          "V(0)=%.1f%%" % vol_pct[0] if len(bins) else "")

    # -- 5b. registration QA before trusting the accumulation ---------------
    qa = deform.compute_jacobian()
    print("jacobian QA: folding %.4f%%, det in [%.3f, %.3f]" % (
        100 * qa["folding_fraction"], qa["det_min"], qa["det_max"]))

    # contour QA: propagate the fraction-day GTV back (voxel indicator
    # warp, Deformable.update_mask) and compare against the plan GTV
    from medicalimageanalysis_tpu.utils import compare_rois
    fx_target = np.zeros((16, 48, 48), np.uint8)
    fx_target[5:11, 16:33, 19:36] = 1           # GTV drawn on fraction
    mapped = deform.update_mask(fx_target)
    img.create_roi(name="GTV_fx_mapped", color=[255, 200, 0])
    img.rois["GTV_fx_mapped"].convert_mask(mapped)
    panel = compare_rois(img, "GTV", "GTV_fx_mapped", tolerance_mm=2.0)
    print("GTV vs mapped fraction GTV:",
          {k: round(v, 3) for k, v in panel.items()})

    # -- 5c. dose QA: gamma vs the planned distribution ----------------------
    # scale the single-fraction grid to the course and gamma-compare the
    # deformably-accumulated dose against it (3%/3mm global, TG-218)
    from medicalimageanalysis_tpu.utils import register_dose_grid
    planned = register_dose_grid(
        np.asarray(Data.dose[fx_dose_name].array, np.float32) * 30.0,
        Data.dose[fx_dose_name], name="Planned course")
    g = planned.compute_gamma("Accumulated", dose_pct=3.0, dta_mm=3.0)
    print("gamma 3%%/3mm: pass %.1f%% (mean %.2f, max %.2f over %d vox)"
          % (g["pass_rate"], g["mean"], g["max"], g["analysed_voxels"]))

    # -- 5d. radiobiology: EQD2-weighted DVH + outcome models ----------------
    acc_eqd2 = acc.compute_eqd2(n_fractions=30, alpha_beta=10.0,
                                name="Accumulated EQD2")
    s2 = acc_eqd2.compute_roi_dose_statistics(plan_ct, "GTV")
    print("GTV EQD2 Dmean %.2f Gy (physical %.2f)"
          % (s2["Dmean"], stats["Dmean"]))
    tcp = acc_eqd2.compute_tcp(plan_ct, "GTV", tcd50=45.0, gamma50=2.0)
    # cold-spot sensitivity is the POINT of a<0: this synthetic GTV has
    # voxels the fraction dose never covered (D95 is ~23 Gy), so the
    # gEUD collapses and TCP ~ 0 — a real plan-evaluation red flag
    d = acc_eqd2.compute_roi_dose_array(plan_ct, "GTV")
    print("TCP(logistic, EQD2): %.1f%% at gEUD %.1f Gy "
          "(%d cold voxels < 5 Gy drive it)"
          % (100 * tcp["tcp"], tcp["gEUD"], int((d < 5.0).sum())))

    # -- 6. export everything back to DICOM ----------------------------------
    out = os.path.join(tmp, "export")
    os.makedirs(out, exist_ok=True)
    acc.create_rtdose(path=os.path.join(out, "rd_accumulated.dcm"),
                      dose_summation_type="MULTI_PLAN")
    img.create_rtstruct(path=os.path.join(out, "rs.dcm"))
    img.create_seg(path=os.path.join(out, "seg.dcm"))
    deform.create_reg(path=os.path.join(out, "dvf_reg.dcm"))
    print("exported:", sorted(os.listdir(out)))

    # sanity: exported accumulated dose re-ingests bit-consistently
    Data.clear()
    mia.read_dicoms(folder_path=out)
    print("re-ingest of export dir:", "doses:", Data.dose_list,
          "(images: none, as expected)" if not Data.image_list else "")
    print("OK")


if __name__ == "__main__":
    main()
