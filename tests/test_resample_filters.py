"""Resample + filter kernel tests vs scipy goldens (BASELINE config #3)."""

import numpy as np
import pytest
from scipy import ndimage

from medicalimageanalysis_tpu.ops import geometry as geo
from medicalimageanalysis_tpu.ops.resample import (
    affine_resample, compose_pixel_matrix, map_coordinates_trilinear,
    reslice_transform, separable_resample, trilinear_gather)


def test_affine_identity(rng):
    vol = rng.normal(size=(8, 10, 12)).astype(np.float32)
    out = affine_resample(vol, np.eye(4), vol.shape, background=0)
    np.testing.assert_allclose(np.asarray(out), vol, atol=1e-5)


def test_trilinear_matches_scipy(rng):
    vol = rng.normal(size=(12, 14, 16)).astype(np.float32)
    coords_xyz = rng.uniform(0, 11, size=(200, 3)).astype(np.float32)
    mine = np.asarray(trilinear_gather(vol, coords_xyz, background=0.0))
    # scipy map_coordinates expects (z, y, x) index order
    golden = ndimage.map_coordinates(
        vol, [coords_xyz[:, 2], coords_xyz[:, 1], coords_xyz[:, 0]],
        order=1, mode="constant")
    np.testing.assert_allclose(mine, golden, atol=1e-4)


def test_map_coordinates_wrapper(rng):
    vol = rng.normal(size=(9, 9, 9)).astype(np.float32)
    coords = rng.uniform(0, 8, size=(3, 50)).astype(np.float32)
    mine = np.asarray(map_coordinates_trilinear(vol, coords))
    golden = ndimage.map_coordinates(vol, coords, order=1)
    np.testing.assert_allclose(mine, golden, atol=1e-4)


def test_background_fill(rng):
    vol = np.ones((4, 4, 4), np.float32)
    coords = np.array([[10.0, 10.0, 10.0], [-5.0, 0.0, 0.0]], np.float32)
    out = np.asarray(trilinear_gather(vol, coords))
    np.testing.assert_allclose(out, [-3001.0, -3001.0])


def test_separable_matches_affine(rng):
    vol = rng.normal(size=(16, 16, 16)).astype(np.float32)
    out_shape = (8, 8, 8)
    sep = np.asarray(separable_resample(vol, out_shape))
    A = np.diag([2.0, 2.0, 2.0, 1.0])  # out pixel p -> in pixel 2p
    aff = np.asarray(affine_resample(vol, A, out_shape, background=0))
    np.testing.assert_allclose(sep, aff, atol=1e-4)


def test_reslice_transform_identity(rng):
    vol = rng.normal(size=(6, 8, 10)).astype(np.float32)
    out = reslice_transform(vol, np.eye(3), [1, 1, 1], [0, 0, 0],
                            np.eye(4), [1, 1, 1], background=0)
    assert out["array"].shape == vol.shape
    np.testing.assert_allclose(out["array"], vol, atol=1e-4)
    np.testing.assert_allclose(out["origin"], [0, 0, 0], atol=1e-6)


def test_reslice_transform_translation(rng):
    """A pure translation reslice shifts the output origin, not data."""
    vol = rng.normal(size=(6, 8, 10)).astype(np.float32)
    T = np.eye(4)
    T[:3, 3] = [3.0, -2.0, 1.0]  # output p samples input at p + t
    out = reslice_transform(vol, np.eye(3), [1, 1, 1], [0, 0, 0], T,
                            [1, 1, 1], background=0)
    np.testing.assert_allclose(out["origin"], [-3.0, 2.0, -1.0],
                               atol=1e-6)
    np.testing.assert_allclose(out["array"], vol, atol=1e-4)


def test_gaussian_matches_scipy(rng):
    from medicalimageanalysis_tpu.ops.filters import gaussian_filter
    vol = rng.normal(size=(16, 16, 16)).astype(np.float32)
    mine = np.asarray(gaussian_filter(vol, 2.0))
    golden = ndimage.gaussian_filter(vol, sigma=2.0, mode="nearest",
                                     truncate=4.0)
    np.testing.assert_allclose(mine, golden, atol=2e-3)


def test_morphology_matches_scipy():
    from medicalimageanalysis_tpu.ops.filters import (binary_dilate,
                                                      binary_erode)
    mask = np.zeros((10, 10, 10), np.uint8)
    mask[3:7, 3:7, 3:7] = 1
    er = binary_erode(mask, size=3)
    di = binary_dilate(mask, size=3)
    golden_er = ndimage.binary_erosion(
        mask, structure=np.ones((3, 3, 3)), border_value=0)
    golden_di = ndimage.binary_dilation(mask, structure=np.ones((3, 3, 3)))
    np.testing.assert_array_equal(er.astype(bool), golden_er)
    np.testing.assert_array_equal(di.astype(bool), golden_di)


def test_external_threshold():
    from medicalimageanalysis_tpu.utils.image.threshold import external
    vol = np.full((8, 16, 16), -1000.0)
    vol[2:6, 4:12, 4:12] = 50.0     # body
    vol[3:5, 6:10, 6:10] = -800.0   # internal air pocket (hole)
    vol[0, 0, 0] = 100.0            # small noise speck
    mask = external(vol, threshold=-250)
    # hole filled, speck is separate and smaller -> excluded
    assert mask[3, 8, 8] == 1
    assert mask[0, 0, 0] == 0
    assert mask[2:6, 4:12, 4:12].all()


def test_offaxis_reslice_display(tmp_path, rng):
    """Image.update_rotation produces a resliced secondary array."""
    import medicalimageanalysis_tpu as mia
    from medicalimageanalysis_tpu.data import Data
    from helpers import write_ct_series

    arr = rng.integers(-500, 500, size=(10, 24, 24)).astype(np.int16)
    write_ct_series(tmp_path / "ct", arr, spacing=(1, 1), thickness=1.0)
    mia.read_dicoms(folder_path=str(tmp_path))
    img = Data.image["CT 01"]
    img.update_rotation(r_z=10)
    assert img.display.secondary_array is not None
    # rotated bbox is larger than the original
    assert img.display.secondary_array.shape[1] >= 24
    sl = img.retrieve_array_plane("Axial")
    assert sl is not None and sl.ndim == 2
    img.reset_array()
    assert img.display.secondary_array is None


def test_batched_morphology(rng):
    from medicalimageanalysis_tpu.ops.filters import (binary_dilate,
                                                      binary_erode)
    masks = np.zeros((3, 8, 10, 10), np.uint8)
    masks[:, 2:6, 3:8, 3:8] = 1
    er = binary_erode(masks, size=3)
    di = binary_dilate(masks, size=3)
    assert er.shape == masks.shape and di.shape == masks.shape
    from scipy import ndimage
    for b in range(3):
        np.testing.assert_array_equal(
            er[b].astype(bool),
            ndimage.binary_erosion(masks[b], np.ones((3, 3, 3)),
                                   border_value=0))
        np.testing.assert_array_equal(
            di[b].astype(bool),
            ndimage.binary_dilation(masks[b], np.ones((3, 3, 3))))


def test_largest_component_batch_matches_scipy(rng):
    """Device label-propagation CC vs host scipy (26-connectivity)."""
    from medicalimageanalysis_tpu.ops.filters import (
        largest_component, largest_component_batch)

    masks = []
    for b in range(3):
        m = rng.random((12, 24, 24)) > 0.72
        m[:, :2, :] = False  # carve structure so components separate
        m[:, :, 11:13] = False
        masks.append(m)
    batch = np.stack(masks)
    out = largest_component_batch(batch)
    for b in range(3):
        golden, _ = largest_component(masks[b])
        assert (out[b] == golden).all()


def test_bitpack12_roundtrip(rng):
    """pack12/unpack12_device: lossless 12-bit staging round trip,
    range gating, odd tails."""
    import jax.numpy as jnp

    from medicalimageanalysis_tpu.ops.bitpack import (pack12,
                                                      unpack12_device)

    for shape in [(3, 5, 40), (2, 7, 37), (1, 13)]:
        arr = rng.integers(-1000, 3000, size=shape).astype(np.int16)
        packed = pack12(arr)
        assert packed is not None
        words, lo, tail = packed
        assert words.shape[-1] == 3 * ((shape[-1] + 7) // 8)
        out = np.asarray(unpack12_device(words, lo, tail,
                                         dtype=jnp.int32))
        np.testing.assert_array_equal(out, arr.astype(np.int32))
        # 25% fewer staged bytes (modulo the pad-to-8 tail)
        padded = arr.shape[-1] + (-arr.shape[-1]) % 8
        assert words.nbytes == 0.75 * arr.nbytes / arr.shape[-1] * padded

    # range beyond 12 bits -> honest refusal
    wide = rng.integers(-30000, 30000, size=(4, 16)).astype(np.int16)
    assert pack12(wide) is None
    # floats refused
    assert pack12(rng.normal(size=(4, 8)).astype(np.float32)) is None
