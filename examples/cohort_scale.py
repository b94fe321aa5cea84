"""Cohort-scale walkthrough on a (data, space) device mesh.

The scaling story end-to-end (SURVEY §2.11 / BASELINE north star):
synthesize a cohort of CT series on disk, then

1. `ingest_cohort`      — host parse/assemble, ONE batched device
                          program for rescale + resample + Gaussian +
                          external mask (no per-series round trips);
2. batched 6-DoF rigid  — every pair descends in one compiled program
                          per pyramid level, pair axis sharded over
                          'data';
3. batched fast demons  — deformable refinement, pair axis sharded
                          over 'data' (each chip maps its local pairs;
                          use demons_z_sharded when single volumes need
                          splitting);
4. `demons_z_sharded`   — the sequence-parallel alternative: ONE large
                          volume z-sharded over 'space' with halo
                          exchange (for volumes too big for one chip).

Run: python examples/cohort_scale.py
(a virtual 8-device CPU mesh by default; MIA_COHORT_ON_DEVICE=1 runs it
on the default backend's devices)
"""

import os
import sys
import tempfile

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main():
    # deterministic 8-device CPU mesh by default (one accelerator
    # degenerates the scaling demo to a (1, 1) mesh); set
    # MIA_COHORT_ON_DEVICE=1 to run on the default backend's devices
    import jax
    if os.environ.get("MIA_COHORT_ON_DEVICE") != "1":
        os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                                   + " --xla_force_host_platform_device"
                                     "_count=8")
        jax.config.update("jax_platforms", "cpu")

    import jax.numpy as jnp

    from medicalimageanalysis_tpu.models.rigid_intensity import (
        register_rigid_intensity_batch)
    from medicalimageanalysis_tpu.ops import geometry as geo
    from medicalimageanalysis_tpu.parallel.batch import demons_batch
    from medicalimageanalysis_tpu.parallel.cohort import ingest_cohort
    from medicalimageanalysis_tpu.parallel.halo import demons_z_sharded
    from medicalimageanalysis_tpu.parallel.mesh import make_mesh
    from medicalimageanalysis_tpu.data import Data
    from medicalimageanalysis_tpu.utils.creation import CreateDicomImage

    n_dev = len(jax.devices())
    space = 2 if n_dev % 2 == 0 else 1
    mesh = make_mesh(n_dev, space=space)
    print(f"mesh: {dict(mesh.shape)} on {jax.default_backend()}")

    # -- synthesize a cohort: 4 patients, same anatomy, per-patient shift
    rng = np.random.default_rng(0)
    tmp = tempfile.mkdtemp(prefix="mia_cohort_")
    zz, yy, xx = np.mgrid[0:16, 0:64, 0:64].astype(np.float32)
    body = (np.exp(-(((zz - 8) / 5) ** 2 + ((yy - 32) / 18) ** 2
                     + ((xx - 32) / 18) ** 2)) * 1200 - 1000)
    dirs = []
    for p in range(4):
        arr = np.roll(body, shift=p, axis=2) \
            + rng.normal(0, 8, body.shape)
        d = os.path.join(tmp, f"pat{p}")
        CreateDicomImage(d, arr.astype(np.int16), spacing=[1.0, 1.0],
                         thickness=2.0).run()
        dirs.append(d)

    # -- 1. cohort ingest: one batched device program ------------------
    results = ingest_cohort(
        folder_path=tmp, out_shape=(16, 64, 64), mesh=mesh)
    names = sorted(results)
    print(f"ingested {len(names)} series; volume[0] "
          f"{results[names[0]]['volume'].shape}, device-resident")

    # -- 2. batched rigid registration over 'data' ---------------------
    vols = np.stack([np.asarray(results[n]["volume"]) for n in names])
    B = vols.shape[0]
    refs = np.broadcast_to(vols[0], vols.shape).copy()
    p2p = geo.pixel_to_position_matrix(np.eye(3), np.ones(3),
                                       np.zeros(3)).astype(np.float32)
    pos2pix = np.linalg.inv(p2p).astype(np.float32)
    centers = np.tile(np.array([32.0, 32.0, 8.0], np.float32), (B, 1))
    lo, hi = np.percentile(refs, [2, 98])
    nrm = lambda a: np.clip((a - lo) / max(hi - lo, 1e-6), 0, 1) \
        .astype(np.float32)
    poses, losses = register_rigid_intensity_batch(
        nrm(refs), nrm(vols),
        np.broadcast_to(p2p, (B, 4, 4)).copy(),
        np.broadcast_to(pos2pix, (B, 4, 4)).copy(), centers,
        levels=((2, 40, 0.2), (1, 25, 0.05)), mesh=mesh)
    # series ingest order need not match patient order: shifts are
    # relative to the first series; the SET must be {0,1,2,3} + offset
    rel = np.round(poses[:, 3] - poses[:, 3].min()).astype(int)
    print("recovered x-shifts:", np.round(poses[:, 3], 2),
          f"-> relative set {sorted(rel.tolist())} (truth [0, 1, 2, 3])")

    # -- 3. batched demons over ('data', 'space') ----------------------
    dvfs = np.asarray(demons_batch(nrm(refs), nrm(vols), iterations=15,
                                   mesh=mesh))
    print(f"demons batch DVFs {dvfs.shape}, "
          f"max |d| {np.abs(dvfs).max():.2f} mm")

    # -- 4. sequence-parallel demons: one volume over 'space' ----------
    if mesh.shape["space"] > 1:
        d1 = demons_z_sharded(nrm(refs)[0], nrm(vols)[1], mesh,
                              iterations=10, std=1, halo=8)
        print(f"z-sharded demons DVF {d1.shape}, "
              f"max |d| {np.abs(d1).max():.2f} mm")

    # -- 5. cohort QA in one program: seg panel + DVH over 'data' ------
    from medicalimageanalysis_tpu.parallel.batch import (
        compare_masks_batch, dvh_batch)

    masks_auto = np.stack(
        [np.asarray(results[n]["mask"]) for n in names]).astype(np.uint8)
    masks_manual = np.roll(masks_auto, (0, 1, 1, -1), (0, 1, 2, 3))
    qa = compare_masks_batch(masks_auto, masks_manual, (1.0, 1.0, 1.0),
                             tolerance_mm=2.0, mesh=mesh)
    print("seg QA dice:", np.round(qa["dice"], 3),
          "hd95 mm:", np.round(qa["hd95_mm"], 2))
    doses = np.abs(vols).astype(np.float32) / max(np.abs(vols).max(), 1) * 70
    dvh = dvh_batch(doses, masks_auto, 0.001, mesh=mesh)
    print("cohort DVH Dmean Gy:", np.round(dvh["Dmean"], 2))

    # -- 6. cohort geometry converters (round 4): every ROI's contours
    #       rasterized in one pooled pass; meshes voxelized on device --
    from medicalimageanalysis_tpu.parallel.batch import rasterize_batch
    th = np.linspace(0, 2 * np.pi, 24, endpoint=False)
    S, Hh, Ww = masks_auto.shape[1:]
    sets = []
    for b in range(masks_auto.shape[0]):
        contours = [np.stack([Ww / 2 + (6 + b) * np.cos(th),
                              Hh / 2 + (5 + b) * np.sin(th),
                              np.full_like(th, float(z))], axis=1)
                    for z in range(2, S - 2)]
        sets.append(contours)
    rois = rasterize_batch(sets, masks_auto.shape[1:], plane="Axial",
                           mesh=mesh)
    print("cohort rasterized ROI voxels:", rois.sum(axis=(1, 2, 3)))

    from medicalimageanalysis_tpu.ops.marching_cubes import mask_to_mesh
    from medicalimageanalysis_tpu.ops.voxelize import voxelize_batch
    meshes = []
    for b in range(rois.shape[0]):
        m = mask_to_mesh(rois[b], [1.0, 1.0, 1.0], [0, 0, 0], np.eye(3))
        meshes.append((np.asarray(m.points, np.float64),
                       np.asarray(m.faces)))
    revox = voxelize_batch(meshes, rois.shape[1:], plane="Axial")
    agree = [(revox[b] & rois[b]).sum() / max(rois[b].sum(), 1)
             for b in range(rois.shape[0])]
    print("mesh->voxel round-trip overlap:", np.round(agree, 3))

    Data.clear()
    print("cohort walkthrough OK")


if __name__ == "__main__":
    main()
