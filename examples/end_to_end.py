"""End-to-end walkthrough of the framework on synthetic data.

Covers the five BASELINE benchmark configs in one script:
ingest -> FFS volume, RTSTRUCT -> device mask, resample/filter, rigid
registration, mesh pipeline, plus deformable + dose analytics.

Run: python examples/end_to_end.py   (CPU or GPU)
"""

import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import medicalimageanalysis_tpu as mia
from medicalimageanalysis_tpu.data import Data
from medicalimageanalysis_tpu.utils.creation import CreateDicomImage


def main():
    tmp = tempfile.mkdtemp(prefix="mia_demo_")

    # -- 1. synthesize + ingest a CT series --------------------------------
    zz, yy, xx = np.mgrid[0:24, 0:64, 0:64]
    body = 1000 * np.exp(-(((zz - 12) / 8.0) ** 2 + ((yy - 32) / 18.0) ** 2
                           + ((xx - 32) / 18.0) ** 2)) - 1000
    CreateDicomImage(os.path.join(tmp, "ct"), body.astype(np.int16),
                     origin=[-120, -120, -60], spacing=[1.0, 1.0],
                     thickness=2.5).run(patient_name="Demo^Patient")
    report = mia.read_dicoms(folder_path=tmp).report
    print("ingest:", report.summary())

    img = Data.image["CT 01"]
    print("volume:", img.array.shape, "spacing:", img.spacing,
          "origin:", img.origin)

    # -- 2. external contour -> ROI -> device mask -> mesh ------------------
    img.create_external(threshold=-250)
    ext = img.rois["External"]
    mask = ext.compute_mask()
    ext.create_mesh()
    print("external: mask voxels", int(mask.sum()),
          "mesh pts", ext.mesh.number_of_points,
          "volume cc", round(ext.volume / 1000.0, 1))

    # -- 2b. radiomics panel on the ROI (device texture counting) -----------
    rx = img.compute_radiomics("External", bin_width=25.0)
    print("radiomics: Ng", rx["meta"]["Ng"],
          "firstorder Mean", round(rx["firstorder"]["Mean"], 1),
          "GLCM Contrast", round(rx["glcm"]["Contrast"], 3),
          "NGTDM Coarseness", round(rx["ngtdm"]["Coarseness"], 5),
          "Sphericity", round(rx["shape"]["Sphericity"], 3))

    # -- 3. a second (shifted) series + rigid registration ------------------
    moved = np.roll(body, shift=(1, -2), axis=(1, 2))
    CreateDicomImage(os.path.join(tmp, "mr"), moved.astype(np.int16),
                     origin=[-120, -120, -60], spacing=[1.0, 1.0],
                     thickness=2.5).run(modality="MR")
    mia.read_dicoms(folder_path=os.path.join(tmp, "mr"), clear=False)
    mr_name = [n for n in Data.image_list
               if Data.image[n].modality == "MR"][0]

    rigid = mia.Rigid("CT 01", mr_name)
    rigid.compute_intensity(levels=((2, 60, 0.2), (1, 30, 0.05)))
    print("rigid translation (mm):",
          np.round(rigid.retrieve_translation(), 2))
    overlay = rigid.create_image()
    print("overlay grid:", overlay["array"].shape)

    # -- 4. deformable registration ----------------------------------------
    deform = mia.Deformable(reference_name="CT 01", moving_name=mr_name,
                            roi_names=[])
    deform.compute_demons(modality_gradient=False, iterations=25, crop=0)
    print("DVF:", deform.dvf.shape,
          "max |d| mm:", round(float(np.abs(deform.dvf).max()), 2))

    # -- 5. save / reload ----------------------------------------------------
    img.save_image(os.path.join(tmp, "saved"))
    rs = img.create_rtstruct(path=os.path.join(tmp, "rs_out.dcm"))
    print("persisted:", sorted(os.listdir(os.path.join(tmp, "saved",
                                                       "CT 01"))),
          "+ RTSTRUCT with",
          len(rs.StructureSetROISequence), "structure(s)")


if __name__ == "__main__":
    main()
