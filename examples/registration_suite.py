"""Registration walkthrough: every registration family end-to-end.

Runs on CPU by default (MIA_REG_ON_DEVICE=1 runs it on the default
backend). Covers the
surfaces a reference user migrates to:

1. rigid 6-DoF intensity registration, CT<->CT (MSE) and CT<->"MR"
   (Mattes MI) — `Rigid.compute_intensity`
2. an oblique 45-degree reslice — `Rigid.update_rotation` /
   `affine_resample`
3. elastix-parity multi-resolution Mattes-MI B-spline —
   `DeformableJAX.elastix` / `elastix_registration`
4. demons with a coarse-to-fine pyramid — `Deformable.compute_demons`
   — plus the LNCC (ANTs-CC) forces variant registering CT straight
   onto inverted-contrast "MR" (`forces='lncc'`)
5. mesh ICP — `Rigid.compute_icp_vtk` drop-in
"""

import os
import sys
import tempfile

sys.path.insert(0, os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

if os.environ.get("MIA_REG_ON_DEVICE", "0") != "1":
    import jax
    jax.config.update("jax_platforms", "cpu")

import numpy as np
from scipy.ndimage import gaussian_filter

import medicalimageanalysis_tpu as mia
from medicalimageanalysis_tpu.data import Data
from medicalimageanalysis_tpu.utils.creation import CreateDicomImage


def make_anatomy(shape=(24, 64, 64), seed=3):
    rng = np.random.default_rng(seed)
    a = gaussian_filter(rng.normal(size=shape), (1.5, 3, 3))
    a = (a - a.min()) / (a.max() - a.min())
    return (a * 1200 - 100).astype(np.int16)


def main():
    tmp = tempfile.mkdtemp(prefix="mia_reg_")
    ct = make_anatomy()
    moved = np.roll(ct, shift=(0, 3, -2), axis=(0, 1, 2))
    # "MR": inverted monotone contrast of the moved anatomy
    mr = ((ct.max() - moved) * 0.4 + 40).astype(np.int16)

    CreateDicomImage(os.path.join(tmp, "ct"), ct,
                     spacing=[1.0, 1.0], thickness=2.0).run()
    CreateDicomImage(os.path.join(tmp, "ct2"), moved,
                     spacing=[1.0, 1.0], thickness=2.0).run()
    CreateDicomImage(os.path.join(tmp, "mr"), mr, spacing=[1.0, 1.0],
                     thickness=2.0).run(modality="MR")
    mia.read_dicoms(folder_path=tmp)
    names = sorted(Data.image_list)
    # identify by content (series naming order follows acquisition
    # timestamps, which tie within a second for synthetic writes)
    cts = [n for n in names if Data.image[n].modality == "CT"]
    if not np.array_equal(Data.image[cts[0]].array, ct):
        cts = cts[::-1]
    mrs = [n for n in names if Data.image[n].modality == "MR"]
    print("images:", names, "| fixed:", cts[0], "moving:", cts[1])

    # 1a. rigid CT<->CT (mono-modality MSE)
    rigid = mia.Rigid(cts[0], cts[1])
    info = rigid.compute_intensity(levels=((2, 60, 0.2), (1, 40, 0.05)))
    print(f"rigid CT<->CT: t = {np.round(rigid.matrix[:3, 3], 2)} "
          f"(expect ~[-2, 3, 0]), loss {info['loss']:.4f}")
    assert np.allclose(rigid.matrix[:3, 3], [-2, 3, 0], atol=0.7)

    # 1b. rigid CT<->MR (Mattes MI, cross-modality)
    rigid_mi = mia.Rigid(cts[0], mrs[0])
    info = rigid_mi.compute_intensity(
        metric="mi", levels=((2, 80, 0.2), (1, 60, 0.05)))
    print(f"rigid CT<->MR (MI): t = {np.round(rigid_mi.matrix[:3, 3], 2)} "
          f"(expect ~[-2, 3, 0])")
    assert np.allclose(rigid_mi.matrix[:3, 3], [-2, 3, 0], atol=1.0)

    # 2. oblique 45-degree reslice
    img = Data.image[cts[0]]
    img.update_rotation(r_z=45.0)
    sl = img.retrieve_array_plane("Axial")
    print("oblique 45-deg reslice: slice", sl.shape,
          "finite:", bool(np.isfinite(sl).all()))
    img.reset_array()

    # 3. elastix-parity deformable (multi-res Mattes MI)
    from medicalimageanalysis_tpu.utils.deformable.jax_backend import (
        DeformableJAX)
    dj = DeformableJAX(
        reference_image=Data.image[cts[0]].create_volume(),
        moving_image=Data.image[mrs[0]].create_volume())
    dvf = dj.elastix(metric="MI", bins=32, resolution=2, spacing=16,
                     iterations=120, crop=0)
    print("elastix DVF:", dvf["array"].shape,
          "max |d| mm:", round(float(np.abs(dvf["array"]).max()), 2))

    # 4. demons with a pyramid
    deform = mia.Deformable(reference_name=cts[0], moving_name=cts[1],
                            roi_names=[])
    deform.compute_demons(method="fast", modality_gradient=False,
                          iterations=20, crop=0, pyramid=(2, 1))
    out = deform.create_image()
    f = Data.image[cts[0]].array.astype(np.float32)
    m = Data.image[cts[1]].array.astype(np.float32)
    inner = np.s_[2:-2, 4:-4, 4:-4]
    print("demons pyramid: err",
          round(float(np.abs(m - f)[inner].mean()), 1), "->",
          round(float(np.abs(out["array"] - f)[inner].mean()), 1))

    # 4a'. LNCC demons: CT onto inverted-contrast "MR" directly — the
    # cross-modality forces where the intensity-difference update has
    # the wrong sign everywhere. The MR is the (0,3,-2)-rolled anatomy
    # remapped; the stored point-displacement field (the inverse of
    # the solver's sampling field, `_store_dvf`) should approach the
    # constant (2, -3, 0) mm
    d_mr = mia.Deformable(reference_name=cts[0], moving_name=mrs[0],
                          roi_names=[])
    d_mr.compute_demons(method="fast", modality_gradient=False,
                        iterations=80, crop=0, step=1.0,
                        forces="lncc")
    med = np.median(d_mr.dvf[2:-2, 6:-6, 6:-6], axis=(0, 1, 2))
    print("LNCC demons CT<->MR: median DVF", np.round(med, 2),
          "(expect ~[2, -3, 0])")
    assert np.allclose(med, [2, -3, 0], atol=1.0)

    # 4b. landmark TPS: matched POIs -> dense DVF (no intensities)
    truth = np.array([[-90.0, -100.0, -20.0], [-60.0, -80.0, -10.0],
                      [-75.0, -95.0, -25.0], [-55.0, -105.0, -15.0]])
    for i, p in enumerate(truth):
        Data.image[cts[0]].add_poi(poi_name=f"L{i}", point=list(p))
        Data.image[cts[1]].add_poi(poi_name=f"L{i}",
                                   point=list(p + [1.5, -1.0, 0.5]))
    tps = mia.Deformable(reference_name=cts[0], moving_name=cts[1],
                         roi_names=[])
    residual = tps.compute_tps()
    mapped = tps.update_pois()
    tre = max(np.linalg.norm(mapped[f"L{i}"] - truth[i])
              for i in range(len(truth)))
    print("TPS: landmark residual %.4f mm, round-trip TRE %.3f mm"
          % (max(residual.values()), tre))

    # 4c. affine intensity mode (scale/shear families share the
    # rigid machinery; normalize=False — percentile normalization is
    # not scale-invariant)
    r3 = mia.Rigid(cts[0], cts[1])
    info3 = r3.compute_intensity(mode="affine", normalize=False,
                                 levels=((2, 60, 0.2), (1, 30, 0.05)))
    print("affine intensity: loss %.3g, matrix type %s"
          % (info3["loss"],
             r3.create_reg().RegistrationSequence[1]
             .MatrixRegistrationSequence[0].MatrixSequence[0]
             .FrameOfReferenceTransformationMatrixType))

    # 5. mesh ICP on external contours
    Data.image[cts[0]].create_external()
    Data.image[cts[1]].create_external()
    r2 = mia.Rigid(cts[0], cts[1])
    r2.compute_icp_vtk(
        source_mesh=Data.image[cts[1]].rois["External"].mesh,
        target_mesh=Data.image[cts[0]].rois["External"].mesh)
    print("ICP matrix t:", np.round(r2.matrix[:3, 3], 2))
    print("OK")


if __name__ == "__main__":
    main()
