"""Rigid registration tests: device ICP, intensity 6-DoF, Rigid object
(BASELINE config #4)."""

import numpy as np
import pytest
from scipy.spatial.transform import Rotation

import medicalimageanalysis_tpu as mia
from medicalimageanalysis_tpu.data import Data
from medicalimageanalysis_tpu.ops.registration.icp import icp_rigid, kabsch

from helpers import write_ct_series


def sphere_points(n=1500, radius=40.0, seed=0):
    rng = np.random.default_rng(seed)
    v = rng.normal(size=(n, 3))
    v /= np.linalg.norm(v, axis=1, keepdims=True)
    # ellipsoid for orientation information
    return v * radius * np.array([1.0, 0.7, 1.3])


def test_kabsch_exact():
    rng = np.random.default_rng(3)
    src = rng.normal(size=(50, 3)).astype(np.float32)
    R = Rotation.from_euler("xyz", [10, -5, 20], degrees=True).as_matrix()
    t = np.array([4.0, -2.0, 7.0])
    tgt = src @ R.T + t
    m = np.asarray(kabsch(src, tgt))
    np.testing.assert_allclose(m[:3, :3], R, atol=1e-4)
    np.testing.assert_allclose(m[:3, 3], t, atol=1e-3)


def test_icp_recovers_transform():
    src = sphere_points()
    R = Rotation.from_euler("xyz", [4, -3, 6], degrees=True).as_matrix()
    t = np.array([5.0, -8.0, 3.0])
    tgt = src @ R.T + t
    m, info = icp_rigid(src, tgt, distance=1e-7, iterations=100,
                        landmarks=400)
    # src transformed by m should coincide with tgt
    moved = src @ m[:3, :3].T + m[:3, 3]
    rms = np.sqrt(np.mean(np.sum((moved - tgt) ** 2, axis=1)))
    assert rms < 0.5
    assert info["iterations"] >= 1


def test_icp_class_api():
    from medicalimageanalysis_tpu.utils.rigid.icp import ICP
    from medicalimageanalysis_tpu.utils.mesh.trimesh import TriMesh
    src_pts = sphere_points(800, seed=1)
    t = np.array([3.0, 1.0, -2.0])
    tgt_pts = src_pts + t
    src = TriMesh(src_pts, np.zeros((0, 3), np.int32))
    tgt = TriMesh(tgt_pts, np.zeros((0, 3), np.int32))
    icp = ICP(src, tgt)
    icp.compute_vtk(distance=1e-7, iterations=50)
    m = icp.get_matrix()
    np.testing.assert_allclose(m[:3, 3], t, atol=0.2)
    corr = icp.get_correspondence_set()
    assert corr.shape[1] == 2


@pytest.fixture
def two_images(tmp_path, rng):
    base = np.zeros((12, 32, 32), np.float32)
    zz, yy, xx = np.mgrid[0:12, 0:32, 0:32]
    base += 800 * np.exp(-(((zz - 6) / 3.0) ** 2 + ((yy - 14) / 6.0) ** 2
                           + ((xx - 18) / 5.0) ** 2))
    base += rng.normal(0, 5, base.shape)
    moved = np.roll(base, shift=(0, 3, -2), axis=(0, 1, 2))
    write_ct_series(tmp_path / "a", base.astype(np.int16),
                    spacing=(1, 1), thickness=2.0)
    write_ct_series(tmp_path / "b", moved.astype(np.int16),
                    spacing=(1, 1), thickness=2.0, modality="MR")
    mia.read_dicoms(folder_path=str(tmp_path))
    names = sorted(Data.image_list)
    ct = [n for n in names if Data.image[n].modality == "CT"][0]
    mr = [n for n in names if Data.image[n].modality == "MR"][0]
    return ct, mr


def test_rigid_object_registry(two_images):
    ct, mr = two_images
    rigid = mia.Rigid(ct, mr)
    assert rigid.rigid_name == f"{ct}_{mr}"
    assert Data.rigid_list == [f"{ct}_{mr}"]
    # collision suffixing
    rigid2 = mia.Rigid(ct, mr)
    assert rigid2.rigid_name == f"{ct}_{mr}_1"


def test_rigid_create_image_identity(two_images):
    ct, mr = two_images
    rigid = mia.Rigid(ct, mr)
    out = rigid.create_image()
    mov = Data.image[mr]
    assert tuple(out["array"].shape) == tuple(mov.array.shape)
    np.testing.assert_allclose(out["origin"], mov.origin, atol=1e-4)
    np.testing.assert_allclose(out["array"], mov.array, atol=0.5)


def test_rigid_update_translation_rotation(two_images):
    ct, mr = two_images
    rigid = mia.Rigid(ct, mr)
    rigid.update_translation(t_x=5, t_y=-2, t_z=1)
    np.testing.assert_allclose(rigid.retrieve_translation(), [5, -2, 1])
    rigid.update_rotation(center=[0, 0, 0], r_z=10)
    ang = rigid.retrieve_angles(order="ZXY")
    assert abs(ang[0] - 10) < 1e-3


def test_rigid_intensity_registration(two_images):
    """Recover a pure translation (y+3 px, x-2 px at 1 mm spacing)."""
    ct, mr = two_images
    rigid = mia.Rigid(ct, mr)
    info = rigid.compute_intensity(
        levels=((2, 80, 0.2), (1, 60, 0.05)))
    # matrix maps reference -> moving physical: moving = ref + (dx, dy)
    t = rigid.matrix[:3, 3]
    # moved = roll(base, y+3, x-2): feature at ref pos p appears in moving
    # at p + (-2, 3, 0) -> ref->mov sampling offset is (-2, +3, 0)
    np.testing.assert_allclose(t, [-2.0, 3.0, 0.0], atol=0.7)
    # registration quality: resampled moving ~ reference
    out = rigid.create_image()
    assert info["loss"] < 0.002


def test_pre_alignment_origin(two_images):
    ct, mr = two_images
    rigid = mia.Rigid(ct, mr)
    rigid.pre_alignment(origin=True)
    np.testing.assert_allclose(
        rigid.matrix[:3, 3],
        np.asarray(Data.image[mr].origin) - np.asarray(Data.image[ct].origin))


def test_pre_alignment_center_and_superior(two_images):
    """center matches the volume centers; superior matches the cranial
    (max physical z) bounds with x/y centered. Reference left both as
    `pass` (structure/rigid.py:763-785); implemented here."""
    ct, mr = two_images
    rigid = mia.Rigid(ct, mr)
    rigid.pre_alignment(center=True)
    expect = (np.asarray(Data.image[mr].compute_center(), float)
              - np.asarray(Data.image[ct].compute_center(), float))
    np.testing.assert_allclose(rigid.matrix[:3, 3], expect, atol=1e-9)

    rigid.pre_alignment(superior=True)
    ct_b = Data.image[ct].compute_bounds()
    mr_b = Data.image[mr].compute_bounds()
    np.testing.assert_allclose(rigid.matrix[2, 3], mr_b[5] - ct_b[5],
                               atol=1e-9)
    np.testing.assert_allclose(rigid.matrix[0, 3], expect[0], atol=1e-9)
    np.testing.assert_allclose(rigid.matrix[1, 3], expect[1], atol=1e-9)


def test_icp_point_to_plane():
    """Point-to-plane ICP on a meshed surface recovers a small rigid
    transform."""
    from medicalimageanalysis_tpu.ops.marching_cubes import (
        marching_cubes_mask)
    from medicalimageanalysis_tpu.utils.rigid.icp import ICP
    mask = np.zeros((16, 20, 24), np.uint8)
    mask[4:12, 5:15, 6:18] = 1
    mask[6:10, 8:12, 10:14] = 0  # notch for orientation info
    mesh = marching_cubes_mask(mask)
    R = Rotation.from_euler("xyz", [2, -3, 4], degrees=True).as_matrix()
    t = np.array([1.5, -2.0, 1.0])
    moved = mesh.copy()
    moved.points = mesh.points @ R.T + t

    icp = ICP(mesh, moved)
    icp.compute_o3d(method="plane", iterations=60)
    m = icp.get_matrix()
    out = mesh.points @ m[:3, :3].T + m[:3, 3]
    rms = np.sqrt(np.mean(np.sum((out - moved.points) ** 2, axis=1)))
    assert rms < 0.3


def test_rigid_combo_matrix_naming(two_images):
    ct, mr = two_images
    combo = np.eye(4)
    combo[0, 3] = 2.0
    rigid = mia.Rigid(ct, mr, combo_matrix=combo, combo_name="stage2")
    assert rigid.rigid_name == f"{ct}_{mr}_combo"
    # create_image composes matrix @ combo
    out = rigid.create_image()
    mov = Data.image[mr]
    # pure x-translation: array content preserved, origin shifted
    np.testing.assert_allclose(out["origin"][0], mov.origin[0] - 2.0,
                               atol=1e-3)


def test_rigid_intensity_rotation_recovery(tmp_path, rng):
    """Recover a 5-degree in-plane rotation + small shift."""
    from medicalimageanalysis_tpu.ops.resample import (affine_resample,
                                                       compose_pixel_matrix)
    zz, yy, xx = np.mgrid[0:12, 0:48, 0:48]
    base = (900 * np.exp(-(((zz - 6) / 3.0) ** 2 + ((yy - 20) / 8.0) ** 2
                           + ((xx - 30) / 6.0) ** 2))
            + 500 * np.exp(-(((zz - 6) / 3.0) ** 2 + ((yy - 32) / 5.0) ** 2
                             + ((xx - 14) / 7.0) ** 2)))
    base = base.astype(np.float32)

    # moving = base resampled through a known rigid transform
    theta = np.deg2rad(5.0)
    T = np.eye(4)
    T[:2, :2] = [[np.cos(theta), -np.sin(theta)],
                 [np.sin(theta), np.cos(theta)]]
    T[:3, 3] = [2.0, -1.0, 0.0]
    A = compose_pixel_matrix(np.eye(3), [1, 1, 2], [0, 0, 0],
                             np.eye(3), [1, 1, 2], [0, 0, 0],
                             phys_transform=np.linalg.inv(T))
    moving = np.asarray(affine_resample(base, A, base.shape,
                                        background=0.0))

    write_ct_series(tmp_path / "a", base.astype(np.int16),
                    spacing=(1, 1), thickness=2.0, origin=(0, 0, 0))
    write_ct_series(tmp_path / "b", moving.astype(np.int16),
                    spacing=(1, 1), thickness=2.0, origin=(0, 0, 0),
                    modality="MR")
    mia.read_dicoms(folder_path=str(tmp_path))
    names = sorted(Data.image_list)
    ct = [n for n in names if Data.image[n].modality == "CT"][0]
    mr = [n for n in names if Data.image[n].modality == "MR"][0]

    rigid = mia.Rigid(ct, mr)
    rigid.compute_intensity(levels=((2, 120, 0.2), (1, 80, 0.05)))
    ang = rigid.retrieve_angles(order="ZXY")
    # moving(x) = base(T^-1 x) -> features move by T; sampling ref->mov
    # matrix approximates T^-1: z-angle ~ -5 deg
    assert abs(abs(ang[0]) - 5.0) < 1.5, ang
    # quality: converged masked-MSE far below the unregistered MSE
    base_n = (base - base.min()) / (base.max() - base.min())
    mov_n = (moving - moving.min()) / (moving.max() - moving.min())
    unregistered_mse = float(np.mean((base_n - mov_n) ** 2))
    assert rigid.misc["intensity_info"]["loss"] < 0.3 * unregistered_mse


def test_rigid_copy_roi(two_images):
    ct, mr = two_images
    img_ct = Data.image[ct]
    mask = np.zeros(img_ct.array.shape, np.uint8)
    mask[4:8, 10:20, 10:20] = 1
    img_ct.add_roi(roi_name="Organ", color=[0, 255, 0], visible=True)
    img_ct.rois["Organ"].convert_mask(mask)
    Data.image[mr].rois["Organ"].visible = True

    rigid = mia.Rigid(ct, mr)
    rigid.update_translation(t_x=4.0)
    rigid.copy_roi("Organ")
    moved = Data.image[mr].rois["Organ"].mesh
    assert moved is not None
    # projected mesh displaced by the registration translation
    np.testing.assert_allclose(
        np.asarray(moved.center)[0],
        np.asarray(img_ct.rois["Organ"].mesh.center)[0] + 4.0, atol=0.2)


def test_register_rigid_intensity_batch(rng):
    """Cohort registration: lax.map over pairs in one program, and the
    same sharded over the ('data','space') mesh — identical recoveries
    of per-pair known shifts (sub-0.35 voxel)."""
    import jax.numpy as jnp

    from medicalimageanalysis_tpu.models.rigid_intensity import (
        pose_to_matrix, register_rigid_intensity_batch)
    from medicalimageanalysis_tpu.parallel.mesh import make_mesh

    P, Z, Y, X = 4, 16, 32, 32
    zz, yy, xx = np.mgrid[0:Z, 0:Y, 0:X].astype(np.float32)
    shifts = [(0, 2, -1), (1, -2, 2), (0, 3, 1), (1, 1, -2)]
    refs, movs = [], []
    for p in range(P):
        blob = np.exp(-(((zz - 8) / 3) ** 2 + ((yy - 16) / 6) ** 2
                        + ((xx - 16) / 6) ** 2))
        blob += 0.4 * np.exp(-(((zz - 5) / 2) ** 2 + ((yy - 10) / 3) ** 2
                               + ((xx - 22) / 3) ** 2))
        refs.append(blob + rng.normal(0, 0.01, blob.shape))
        movs.append(np.roll(refs[-1], shifts[p], axis=(0, 1, 2)))
    refs = np.stack(refs).astype(np.float32)
    movs = np.stack(movs).astype(np.float32)
    eye = np.broadcast_to(np.eye(4, dtype=np.float32), (P, 4, 4))
    ctrs = np.broadcast_to(np.array([16., 16., 8.], np.float32), (P, 3))

    results = []
    for mesh in (None, make_mesh(8, space=2)):
        poses, _ = register_rigid_intensity_batch(
            refs, movs, eye, eye, ctrs,
            levels=((2, 60, 0.2), (1, 40, 0.05)), mesh=mesh)
        for p in range(P):
            m = np.asarray(pose_to_matrix(jnp.asarray(poses[p]),
                                          jnp.asarray(ctrs[p])))
            want = np.array([shifts[p][2], shifts[p][1], shifts[p][0]],
                            float)
            assert np.abs(m[:3, 3] - want).max() < 0.35
        results.append(poses)
    np.testing.assert_allclose(results[0], results[1], atol=1e-5)


def test_register_intensity_mi_cross_modality():
    """MI metric recovers a known shift between a CT-like volume and a
    nonlinearly intensity-remapped (pseudo-MR) copy where MSE has no
    meaningful optimum (BASELINE config #4's CT<->MR leg)."""
    import jax.numpy as jnp
    from medicalimageanalysis_tpu.models.rigid_intensity import (
        register_rigid_intensity)

    rng = np.random.default_rng(3)
    zz, yy, xx = np.mgrid[0:24, 0:48, 0:48].astype(np.float32)
    ref = (np.exp(-(((zz - 12) / 5) ** 2 + ((yy - 24) / 9) ** 2
                    + ((xx - 24) / 9) ** 2)) * 900
           + np.exp(-(((zz - 7) / 3) ** 2 + ((yy - 12) / 4) ** 2
                      + ((xx - 33) / 4) ** 2)) * 500).astype(np.float32)
    ref += rng.normal(0, 5, ref.shape).astype(np.float32)
    # pseudo-MR: monotonic-free nonlinear remap (intensity INVERSION
    # with a bump) + shift by 3 voxels in x
    remap = 1000.0 - ref + 400.0 * np.exp(-((ref - 400.0) / 150.0) ** 2)
    mov = np.roll(remap, shift=3, axis=2).astype(np.float32)
    mov += rng.normal(0, 5, mov.shape).astype(np.float32)

    class Img:
        def __init__(self, a):
            self.array = a
            self.matrix = np.eye(3)
            self.spacing = np.ones(3)
            self.origin = np.zeros(3)

        def compute_center(self):
            return np.array([24.0, 24.0, 12.0])

    matrix, info = register_rigid_intensity(
        Img(ref), Img(mov), metric="mi",
        levels=((2, 80, 0.2), (1, 40, 0.05)))
    # recovered translation: ref -> mov physical map should carry x -> x+3
    t = matrix[:3, 3]
    assert abs(t[0] - 3.0) < 0.8, f"MI failed to recover shift: t={t}"
    assert abs(t[1]) < 0.8 and abs(t[2]) < 0.8
    rot = matrix[:3, :3]
    assert np.abs(rot - np.eye(3)).max() < 0.05


def test_register_intensity_ncc_linear_remap():
    """NCC is invariant to affine intensity remaps: recovers a shift
    between a volume and a gain/offset-remapped copy."""
    from medicalimageanalysis_tpu.models.rigid_intensity import (
        register_rigid_intensity)

    rng = np.random.default_rng(5)
    zz, yy, xx = np.mgrid[0:24, 0:40, 0:40].astype(np.float32)
    ref = (np.exp(-(((zz - 12) / 5) ** 2 + ((yy - 20) / 8) ** 2
                    + ((xx - 20) / 8) ** 2)) * 800).astype(np.float32)
    ref += rng.normal(0, 4, ref.shape).astype(np.float32)
    mov = np.roll(ref * 0.4 + 120.0, shift=2, axis=1).astype(np.float32)

    class Img:
        def __init__(self, a):
            self.array = a
            self.matrix = np.eye(3)
            self.spacing = np.ones(3)
            self.origin = np.zeros(3)

        def compute_center(self):
            return np.array([20.0, 20.0, 12.0])

    matrix, _ = register_rigid_intensity(
        Img(ref), Img(mov), metric="ncc",
        levels=((2, 60, 0.2), (1, 30, 0.05)))
    t = matrix[:3, 3]
    assert abs(t[1] - 2.0) < 0.6 and abs(t[0]) < 0.6 and abs(t[2]) < 0.6


def test_rigid_compute_intensity_metric_passthrough(two_images):
    """metric= kwarg flows through Rigid.compute_intensity to the
    registration model (structure-level API)."""
    ct, mr = two_images
    rigid = mia.Rigid(ct, mr)
    info = rigid.compute_intensity(
        levels=((2, 80, 0.2), (1, 60, 0.05)), metric="ncc")
    t = rigid.matrix[:3, 3]
    np.testing.assert_allclose(t, [-2.0, 3.0, 0.0], atol=0.8)
    assert "loss" in rigid.misc["intensity_info"]


def test_rigid_update_pois(tmp_path, rng):
    """Rigid landmark propagation matches update_rois' matrix
    semantics: p_ref = inv(matrix @ combo) @ p_moving."""
    arr = rng.integers(0, 100, size=(4, 16, 16)).astype(np.int16)
    write_ct_series(tmp_path / "a", arr)
    write_ct_series(tmp_path / "b", arr, modality="MR")
    mia.read_dicoms(folder_path=str(tmp_path))
    ct = [n for n in Data.image_list
          if Data.image[n].modality == "CT"][0]
    mr = [n for n in Data.image_list
          if Data.image[n].modality == "MR"][0]

    m = np.eye(4)
    m[:3, 3] = [5.0, -3.0, 2.0]   # reference -> moving
    rigid = mia.Rigid(ct, mr, matrix=m)
    p_mov = np.array([-90.0, -110.0, -45.0])
    Data.image[mr].add_poi(poi_name="L0", point=list(p_mov))

    mapped = rigid.update_pois()
    np.testing.assert_allclose(
        mapped["L0"], (np.linalg.inv(m) @ np.append(p_mov, 1.0))[:3],
        atol=1e-9)
    assert "L0" in rigid.pois


def _analytic_pair(true_pose, center, shape=(24, 48, 48)):
    """ref(p) = f(p); mov(q) = f(T^-1 q) with T = pose_to_matrix(true
    pose about `center`) — analytically exact, no interpolation, so an
    intensity fit of mov onto ref must recover T itself."""
    import jax.numpy as jnp
    from medicalimageanalysis_tpu.models.rigid_intensity import (
        pose_to_matrix)

    def f(x, y, z):
        # anisotropic two-blob scene pins rotation, scale AND shear
        return (900 * np.exp(-(((z - 12) / 4) ** 2 + ((y - 24) / 11) ** 2
                               + ((x - 22) / 6) ** 2))
                + 500 * np.exp(-(((z - 8) / 3) ** 2 + ((y - 13) / 4) ** 2
                                 + ((x - 33) / 5) ** 2)))

    T = np.asarray(pose_to_matrix(jnp.asarray(true_pose, jnp.float32),
                                  jnp.asarray(center, jnp.float32)),
                   np.float64)
    Ti = np.linalg.inv(T)
    zz, yy, xx = np.mgrid[0:shape[0], 0:shape[1], 0:shape[2]]
    ref = f(xx, yy, zz).astype(np.float32)
    q = np.stack([xx, yy, zz, np.ones_like(xx)], axis=-1).reshape(-1, 4)
    p = q @ Ti.T
    mov = f(p[:, 0], p[:, 1], p[:, 2]).reshape(shape).astype(np.float32)

    class Img:
        def __init__(self, a):
            self.array = a
            self.matrix = np.eye(3)
            self.spacing = np.ones(3)
            self.origin = np.zeros(3)

        def compute_center(self):
            return np.asarray(center, float)

    return Img(ref), Img(mov), T


def test_register_intensity_similarity_recovers_scale():
    """mode='similarity' recovers an isotropic 6% shrink + small
    rotation + translation that 6-DoF rigid cannot represent."""
    from medicalimageanalysis_tpu.models.rigid_intensity import (
        register_rigid_intensity)

    true_pose = np.array([0.03, -0.02, 0.04, 2.0, -1.0, 1.0,
                          np.log(0.94)], np.float32)
    center = [24.0, 24.0, 12.0]
    ref, mov, T = _analytic_pair(true_pose, center)

    # normalize=False: the per-volume percentile normalization is NOT
    # invariant to a scale change (the shrunk volume's histogram
    # differs), which would bias the fitted scale by ~3%
    matrix, info = register_rigid_intensity(
        ref, mov, mode="similarity", normalize=False,
        levels=((2, 120, 0.2), (1, 80, 0.05)))
    assert np.abs(matrix[:3, :3] - T[:3, :3]).max() < 0.01
    assert np.abs(matrix[:3, 3] - T[:3, 3]).max() < 0.5
    # the fitted log-scale itself lands near truth
    assert abs(info["pose"][6] - np.log(0.94)) < 0.01

    # rigid mode CANNOT represent the scale: its best loss stays well
    # above the similarity fit's
    _, info_r = register_rigid_intensity(
        ref, mov, mode="rigid", normalize=False,
        levels=((2, 120, 0.2), (1, 80, 0.05)))
    assert info["loss"] < info_r["loss"] * 0.5


def test_register_intensity_affine_recovers_shear():
    from medicalimageanalysis_tpu.models.rigid_intensity import (
        register_rigid_intensity)

    true_pose = np.zeros(12, np.float32)
    true_pose[:3] = [0.02, -0.015, 0.03]
    true_pose[3:6] = [1.5, -1.0, 0.5]
    true_pose[6:9] = [0.04, -0.03, 0.02]      # log per-axis scales
    true_pose[9:12] = [0.03, -0.02, 0.025]    # shears
    center = [24.0, 24.0, 12.0]
    ref, mov, T = _analytic_pair(true_pose, center)

    matrix, info = register_rigid_intensity(
        ref, mov, mode="affine", normalize=False,
        levels=((2, 150, 0.2), (1, 100, 0.05)))
    assert np.abs(matrix[:3, :3] - T[:3, :3]).max() < 0.015
    assert np.abs(matrix[:3, 3] - T[:3, 3]).max() < 0.6


def test_register_intensity_mode_validation(two_images):
    from medicalimageanalysis_tpu.models.rigid_intensity import (
        register_rigid_intensity)
    ref, mov = two_images
    with pytest.raises(ValueError, match="unknown mode"):
        register_rigid_intensity(ref, mov, mode="projective")
    with pytest.raises(ValueError, match="pose0"):
        register_rigid_intensity(ref, mov, mode="similarity",
                                 pose0=np.zeros(6))


def test_compute_landmarks_recovers_transform(two_images):
    """Umeyama over matched POIs: exact recovery of a known rigid (and
    similarity) map, stored in the matrix @ combo convention."""
    ct, mr = two_images
    R = Rotation.from_euler("xyz", [5, -3, 8], degrees=True).as_matrix()
    t = np.array([4.0, -6.0, 2.5])
    pts = np.array([[-90.0, -110.0, -45.0], [-60.0, -90.0, -40.0],
                    [-75.0, -100.0, -35.0], [-50.0, -120.0, -42.0],
                    [-85.0, -95.0, -50.0]])
    for i, p in enumerate(pts):
        Data.image[ct].add_poi(poi_name=f"F{i}", point=list(p))
        Data.image[mr].add_poi(poi_name=f"F{i}", point=list(R @ p + t))
    rigid = mia.Rigid(ct, mr)
    res = rigid.compute_landmarks()
    assert max(res.values()) < 1e-6
    F = rigid.matrix @ rigid.combo_matrix
    np.testing.assert_allclose(F[:3, :3], R, atol=1e-8)
    np.testing.assert_allclose(F[:3, 3], t, atol=1e-6)
    # similarity variant
    s = 1.07
    for i, p in enumerate(pts):
        Data.image[mr].pois[f"F{i}"].point_position = s * (R @ p) + t
    rigid.compute_landmarks(scaling=True)
    F = rigid.matrix @ rigid.combo_matrix
    np.testing.assert_allclose(F[:3, :3], s * R, atol=1e-6)
    # validation: too few matches / mismatched explicit arrays
    with pytest.raises(ValueError, match=">= 3"):
        mia.Rigid(ct, mr).compute_landmarks(poi_names=["F0"])
    with pytest.raises(ValueError, match="together"):
        mia.Rigid(ct, mr).compute_landmarks(points_reference=pts)


def test_resample_to_matches_golden(tmp_path):
    """Image.resample_to: composed pixel matrix + affine warp
    lands on a scipy map_coordinates golden for an interior grid."""
    from scipy import ndimage

    from medicalimageanalysis_tpu.ops.resample import (
        compose_pixel_matrix)

    Data.clear()
    rng = np.random.default_rng(4)
    arr = rng.integers(-200, 900, (12, 32, 32)).astype(np.int16)
    write_ct_series(tmp_path / "a", arr, spacing=(1, 1), thickness=2.0)
    write_ct_series(tmp_path / "b", np.zeros((6, 12, 12), np.int16),
                    origin=(-98.0, -118.0, -49.0), spacing=(2, 2),
                    thickness=4.0, modality="MR")
    mia.read_dicoms(folder_path=str(tmp_path))
    names = sorted(Data.image_list)
    a = Data.image[[n for n in names
                    if Data.image[n].modality == "CT"][0]]
    b = Data.image[[n for n in names
                    if Data.image[n].modality == "MR"][0]]
    out = a.resample_to(b)
    assert out.shape == tuple(b.dimensions) and out.dtype == np.float32

    A = compose_pixel_matrix(a.matrix, a.spacing, a.origin,
                             b.matrix, b.spacing, b.origin)
    zz, yy, xx = np.meshgrid(*[np.arange(n, dtype=np.float64)
                               for n in b.dimensions], indexing="ij")
    ones = np.ones_like(xx)
    pix_in = np.einsum(
        "rc,czyx->rzyx", np.asarray(A, np.float64),
        np.stack([xx, yy, zz, ones]))
    golden = ndimage.map_coordinates(
        a.array.astype(np.float64),
        [pix_in[2], pix_in[1], pix_in[0]], order=1)
    np.testing.assert_allclose(out, golden, atol=0.01)
    # values mode + shape validation
    mask = (a.array > 200).astype(np.float32)
    mout = a.resample_to(b, values=mask, background=0.0)
    assert mout.min() >= 0.0 and mout.max() <= 1.0
    with pytest.raises(ValueError, match="values shape"):
        a.resample_to(b, values=np.zeros((2, 2, 2)))
