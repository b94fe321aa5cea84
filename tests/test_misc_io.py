"""NIfTI reader, ingest report, persistence, exports, planar modality
tests."""

import gzip
import struct

import numpy as np
import pytest

import medicalimageanalysis_tpu as mia
from medicalimageanalysis_tpu.data import Data

from helpers import write_ct_series


def write_nifti(path, arr, spacing=(1.0, 1.0, 2.0), origin_ras=(0, 0, 0),
                gz=False):
    """Minimal NIfTI-1 writer for tests (sform identity * spacing)."""
    header = bytearray(352)
    struct.pack_into("<i", header, 0, 348)
    nz, ny, nx = arr.shape
    struct.pack_into("<8h", header, 40, 3, nx, ny, nz, 1, 1, 1, 1)
    dt = {np.dtype(np.int16): 4, np.dtype(np.float32): 16,
          np.dtype(np.uint8): 2}[arr.dtype]
    struct.pack_into("<h", header, 70, dt)
    struct.pack_into("<h", header, 72, arr.dtype.itemsize * 8)
    struct.pack_into("<8f", header, 76, 1.0, spacing[0], spacing[1],
                     spacing[2], 1, 1, 1, 1)
    struct.pack_into("<f", header, 108, 352.0)  # vox_offset
    struct.pack_into("<f", header, 112, 1.0)    # scl_slope
    struct.pack_into("<h", header, 254, 1)      # sform_code
    struct.pack_into("<4f", header, 280, spacing[0], 0, 0, origin_ras[0])
    struct.pack_into("<4f", header, 296, 0, spacing[1], 0, origin_ras[1])
    struct.pack_into("<4f", header, 312, 0, 0, spacing[2], origin_ras[2])
    header[344:348] = b"n+1\x00"
    payload = bytes(header) + arr.astype(arr.dtype.newbyteorder("<")) \
        .tobytes()
    if gz:
        with gzip.open(str(path), "wb") as f:
            f.write(payload)
    else:
        with open(str(path), "wb") as f:
            f.write(payload)


def test_read_nifti(tmp_path, rng):
    arr = rng.integers(-500, 500, size=(5, 12, 16)).astype(np.int16)
    write_nifti(tmp_path / "scan.nii", arr, spacing=(0.8, 0.8, 3.0),
                origin_ras=(100.0, 120.0, -50.0))
    mia.read_nifti(str(tmp_path / "scan.nii"))
    assert "scan" in Data.image_list
    img = Data.image["scan"]
    np.testing.assert_array_equal(img.array, arr)
    np.testing.assert_allclose(img.spacing, [0.8, 0.8, 3.0])
    # RAS origin (100, 120, z) -> LPS (-100, -120, z)
    np.testing.assert_allclose(img.origin, [-100.0, -120.0, -50.0],
                               atol=1e-4)


def test_read_nifti_gz(tmp_path, rng):
    arr = rng.normal(size=(4, 8, 8)).astype(np.float32)
    write_nifti(tmp_path / "scan.nii.gz", arr, gz=True)
    mia.read_nifti(str(tmp_path / "scan.nii.gz"), image_name="vol")
    np.testing.assert_allclose(Data.image["vol"].array, arr, atol=1e-6)


def test_ingest_report(tmp_path, rng):
    arr = rng.integers(0, 100, size=(4, 16, 16)).astype(np.int16)
    write_ct_series(tmp_path / "ct", arr)
    (tmp_path / "ct" / "junk.dcm").write_bytes(b"not a dicom file")
    reader = mia.read_dicoms(folder_path=str(tmp_path))
    r = reader.report
    assert r.files_total == 5
    assert r.parsed_ok == 4
    assert len(r.failed_files) == 1
    assert r.images_created == ["CT 01"]
    assert r.elapsed_s > 0
    s = r.summary()
    assert s["failed"] == 1 and s["images"] == ["CT 01"]


def test_image_save_load_roundtrip(tmp_path, rng):
    from helpers import square_contour_mm, write_rtstruct
    arr = rng.integers(-200, 800, size=(6, 16, 16)).astype(np.int16)
    info = write_ct_series(tmp_path / "ct", arr)
    rois = {"Liver": [(square_contour_mm(info, z, 4, 10), z)
                      for z in range(1, 4)]}
    write_rtstruct(tmp_path / "ct" / "rs.dcm", info, rois)
    mia.read_dicoms(folder_path=str(tmp_path))
    img = Data.image["CT 01"]
    img.save_image(str(tmp_path / "saved"))

    Data.clear()
    from medicalimageanalysis_tpu.structure.image import Image
    restored = Image.load_image(str(tmp_path / "saved" / "CT 01"))
    np.testing.assert_array_equal(restored.array, arr)
    np.testing.assert_allclose(restored.spacing, img.spacing)
    assert "Liver" in restored.rois
    assert len(restored.rois["Liver"].contour_position) == 3


def test_rigid_save_load(tmp_path, rng):
    arr = rng.integers(0, 100, size=(4, 16, 16)).astype(np.int16)
    write_ct_series(tmp_path / "a", arr)
    write_ct_series(tmp_path / "b", arr, modality="MR")
    mia.read_dicoms(folder_path=str(tmp_path))
    names = sorted(Data.image_list)
    rigid = mia.Rigid(names[0], names[1])
    rigid.update_translation(t_x=3)
    rigid.save_rigid(str(tmp_path / "rigid_out"))

    from medicalimageanalysis_tpu.structure.rigid import Rigid
    loaded = Rigid.load_rigid(str(tmp_path / "rigid_out"))
    np.testing.assert_allclose(loaded.matrix, rigid.matrix)


def test_xray_reader(tmp_path, rng):
    from medicalimageanalysis_tpu.dicom import (Dataset, dcmwrite,
                                                generate_uid, uids)
    arr = rng.integers(0, 4000, size=(32, 24)).astype(np.uint16)
    ds = Dataset()
    ds.SOPClassUID = uids.DXImageStorage
    ds.SOPInstanceUID = generate_uid()
    ds.Modality = "DX"
    ds.PatientID = "X"
    ds.PatientOrientation = ["L", "F"]
    ds.Rows, ds.Columns = 32, 24
    ds.BitsAllocated = 16
    ds.BitsStored = 16
    ds.HighBit = 15
    ds.PixelRepresentation = 0
    ds.SamplesPerPixel = 1
    ds.PhotometricInterpretation = "MONOCHROME2"
    ds.ImagerPixelSpacing = [0.14, 0.14]
    ds.PresentationLUTShape = "Inverse"
    ds.PixelData = arr.astype("<u2").tobytes()
    (tmp_path / "dx").mkdir()
    dcmwrite(tmp_path / "dx" / "img.dcm", ds)

    mia.read_dicoms(folder_path=str(tmp_path))
    img = Data.image["DX 01"]
    assert img.plane == "Coronal"  # 'L' in PatientOrientation
    assert img.array.shape == (32, 1, 24)
    # LUT inversion pivots on the max stored value for BitsStored=16
    # (REFERENCE BUG FIXED: hardcoded 16383 is only right for 14-bit),
    # and unsigned 16-bit input widens to int32 instead of wrapping
    assert img.array.dtype == np.int32
    expected = 65535 - arr.astype(np.int32)
    np.testing.assert_array_equal(
        img.array, np.flip(np.flip(expected.reshape(32, 1, 24), 0), 1))


def test_us_reader(tmp_path, rng):
    from medicalimageanalysis_tpu.dicom import (Dataset, dcmwrite,
                                                generate_uid, uids)
    frames = rng.integers(0, 255, size=(3, 16, 16)).astype(np.uint8)
    rgb = np.stack([frames, frames, frames], axis=-1)  # uniform channels
    rgb[0, 2, 3] = [255, 0, 0]  # one colored overlay pixel
    ds = Dataset()
    ds.SOPClassUID = uids.USImageStorage
    ds.SOPInstanceUID = generate_uid()
    ds.Modality = "US"
    ds.PatientID = "U"
    ds.NumberOfFrames = 3
    ds.Rows, ds.Columns = 16, 16
    ds.BitsAllocated = 8
    ds.BitsStored = 8
    ds.HighBit = 7
    ds.PixelRepresentation = 0
    ds.SamplesPerPixel = 3
    ds.PlanarConfiguration = 0
    ds.PhotometricInterpretation = "RGB"
    ds.PixelData = rgb.tobytes()
    (tmp_path / "us").mkdir()
    dcmwrite(tmp_path / "us" / "us.dcm", ds)

    mia.read_dicoms(folder_path=str(tmp_path))
    img = Data.image["US 01"]
    assert img.array.shape == (3, 16, 16)
    assert img.array[0, 2, 3] == 0  # colored overlay dropped
    assert img.array[1, 2, 3] == frames[1, 2, 3]


def test_us_reader_grayscale(tmp_path, rng):
    """Grayscale US decodes without the channel-uniformity filter: a
    multi-frame cine is (frames, rows, cols) — also ndim 3 — which the
    reference mistakes for channels-last RGB and wipes (PARITY.md)."""
    from medicalimageanalysis_tpu.dicom import (Dataset, dcmwrite,
                                                generate_uid, uids)

    def us_ds(arr, frames):
        ds = Dataset()
        ds.SOPClassUID = uids.USImageStorage
        ds.SOPInstanceUID = generate_uid()
        ds.Modality = "US"
        ds.PatientID = "U"
        if frames > 1:
            ds.NumberOfFrames = frames
        ds.Rows, ds.Columns = arr.shape[-2], arr.shape[-1]
        ds.BitsAllocated = 8
        ds.BitsStored = 8
        ds.HighBit = 7
        ds.PixelRepresentation = 0
        ds.SamplesPerPixel = 1
        ds.PhotometricInterpretation = "MONOCHROME2"
        ds.PixelData = arr.tobytes()
        return ds

    cine = rng.integers(0, 255, size=(4, 16, 16)).astype(np.uint8)
    single = rng.integers(0, 255, size=(16, 16)).astype(np.uint8)
    (tmp_path / "us").mkdir()
    dcmwrite(tmp_path / "us" / "cine.dcm", us_ds(cine, 4))
    dcmwrite(tmp_path / "us" / "single.dcm", us_ds(single, 1))

    mia.read_dicoms(folder_path=str(tmp_path))
    arrays = {Data.image[n].array.shape: Data.image[n].array
              for n in Data.image_list}
    np.testing.assert_array_equal(arrays[(4, 16, 16)], cine)
    np.testing.assert_array_equal(arrays[(1, 16, 16)],
                                  single.reshape(1, 16, 16))
    for n in Data.image_list:
        img = Data.image[n]
        assert list(img.dimensions) == list(img.array.shape)


def test_parallel_preprocess_on_mesh(rng):
    import jax
    from medicalimageanalysis_tpu.parallel.batch import preprocess_batch
    from medicalimageanalysis_tpu.parallel.mesh import make_mesh
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual devices")
    mesh = make_mesh(8, space=2)
    raw = rng.integers(0, 1000, size=(4, 8, 32, 32)).astype(np.int16)
    vols, masks = preprocess_batch(raw, np.ones(4, np.float32),
                                   np.zeros(4, np.float32),
                                   out_shape=(8, 16, 16), mesh=mesh)
    assert vols.shape == (4, 8, 16, 16)
    assert masks.shape == (4, 8, 16, 16)


def test_preprocess_chunked_matches_flat(rng):
    """The batched preprocess equals running every series on its own:
    the batch axis is never contracted, so a series' result does not
    depend on the batch it came in."""
    import jax
    from medicalimageanalysis_tpu.parallel.batch import make_preprocess_fn

    raw = rng.integers(0, 3000, size=(12, 8, 32, 32)).astype(np.int16)
    slopes = rng.uniform(0.5, 2.0, 12).astype(np.float32)
    icepts = rng.uniform(-100, 100, 12).astype(np.float32)
    fn = jax.jit(make_preprocess_fn((8, 32, 32), (8, 16, 16),
                                    ffs_op="ax_rot2"))
    vb, mb = fn(raw, slopes, icepts)
    for b in (0, 5, 11):
        v1, m1 = fn(raw[b:b + 1], slopes[b:b + 1], icepts[b:b + 1])
        np.testing.assert_allclose(np.asarray(vb)[b], np.asarray(v1)[0],
                                   rtol=0, atol=1e-4)
        np.testing.assert_array_equal(np.asarray(mb)[b],
                                      np.asarray(m1)[0])


def test_rf_reader(tmp_path, rng):
    from medicalimageanalysis_tpu.dicom import (Dataset, dcmwrite,
                                                generate_uid, uids)
    frames = rng.integers(0, 4000, size=(5, 16, 20)).astype(np.uint16)
    ds = Dataset()
    ds.SOPClassUID = uids.XRayRFImageStorage
    ds.SOPInstanceUID = generate_uid()
    ds.Modality = "RF"
    ds.PatientID = "R"
    ds.NumberOfFrames = 5
    ds.Rows, ds.Columns = 16, 20
    ds.BitsAllocated = 16
    ds.BitsStored = 16
    ds.HighBit = 15
    ds.PixelRepresentation = 0
    ds.SamplesPerPixel = 1
    ds.PhotometricInterpretation = "MONOCHROME2"
    ds.ImagerPixelSpacing = [0.2, 0.2]
    ds.PixelData = frames.astype("<u2").tobytes()
    (tmp_path / "rf").mkdir()
    dcmwrite(tmp_path / "rf" / "rf.dcm", ds)
    mia.read_dicoms(folder_path=str(tmp_path))
    img = Data.image["RF 01"]
    assert img.array.shape == (5, 16, 20)
    np.testing.assert_allclose(img.spacing, [0.2, 0.2, 1.0])


def test_jpeg_baseline_decode(tmp_path, rng):
    """8-bit JPEG-baseline encapsulated DICOM decodes via cv2."""
    import cv2
    from medicalimageanalysis_tpu.dicom import dcmread, dcmwrite, uids
    from test_dicom_core import make_ct_slice
    img = np.full((32, 32), 128, np.uint8)
    img[8:24, 8:24] = 200
    ok, enc = cv2.imencode(".jpg", img,
                           [cv2.IMWRITE_JPEG_QUALITY, 95])
    assert ok
    ds = make_ct_slice(np.zeros((32, 32), np.uint16))
    ds.BitsAllocated = 8
    ds.BitsStored = 8
    ds.HighBit = 7
    ds.PixelData = [enc.tobytes()]
    dcmwrite(tmp_path / "jb.dcm", ds,
             transfer_syntax=uids.JPEGBaseline8Bit)
    out = dcmread(tmp_path / "jb.dcm")
    decoded = out.pixel_array
    assert decoded.shape == (32, 32)
    # lossy: interior/exterior levels approximately preserved
    assert abs(int(decoded[16, 16]) - 200) < 10
    assert abs(int(decoded[2, 2]) - 128) < 10


def test_no_extension_dicoms(tmp_path, rng):
    arr = rng.integers(0, 100, size=(3, 8, 8)).astype(np.int16)
    write_ct_series(tmp_path / "ct", arr)
    # strip extensions
    noext = tmp_path / "noext"
    noext.mkdir()
    for p in (tmp_path / "ct").glob("*.dcm"):
        (noext / p.stem).write_bytes(p.read_bytes())
        p.unlink()
    # DICM-sniff ingest is the default (clinical archives commonly
    # ship extension-less; the reference buckets but ignores them)
    mia.read_dicoms(folder_path=str(noext))
    assert Data.image_list == ["CT 01"]
    np.testing.assert_array_equal(Data.image["CT 01"].array, arr)
    # opt out restores the reference's bucket-and-ignore behavior
    mia.read_dicoms(folder_path=str(noext), include_no_extension=False)
    assert Data.image_list == []


def test_poi_point_pixel(tmp_path, rng):
    from helpers import write_rtstruct
    arr = rng.integers(0, 100, size=(4, 16, 16)).astype(np.int16)
    info = write_ct_series(tmp_path / "ct", arr, spacing=(1, 1),
                           thickness=2.0)
    pois = {"Mark": [float(info["origin"][0] + 3),
                     float(info["origin"][1] + 5),
                     float(info["origin"][2] + 2)]}
    write_rtstruct(tmp_path / "ct" / "rs.dcm", info, {}, pois)
    mia.read_dicoms(folder_path=str(tmp_path))
    poi = Data.image["CT 01"].pois["Mark"]
    assert poi.point_pixel is not None
    np.testing.assert_allclose(poi.point_pixel.reshape(-1),
                               [3.0, 5.0, 1.0], atol=1e-3)


def test_only_tags_then_load_array(tmp_path, rng):
    """only_tags ingest + deferred Image.load_array equals a full read."""
    arr = rng.integers(-800, 1200, size=(6, 16, 16)).astype(np.int16)
    write_ct_series(tmp_path / "ct", arr)
    mia.read_dicoms(folder_path=str(tmp_path))
    full = Data.image["CT 01"].array.copy()

    mia.read_dicoms(folder_path=str(tmp_path), only_tags=True)
    img = Data.image["CT 01"]
    assert img.array is None
    loaded = img.load_array()
    np.testing.assert_array_equal(loaded, full)
    np.testing.assert_array_equal(img.array, full)
    # display refreshed with real window
    assert img.display.scroll_max[0] == 5


def test_export_dicom_roundtrip(tmp_path, rng):
    arr = rng.integers(-800, 1200, size=(5, 16, 16)).astype(np.int16)
    write_ct_series(tmp_path / "ct", arr)
    mia.read_dicoms(folder_path=str(tmp_path / "ct"))
    img = Data.image["CT 01"]
    img.export_dicom(tmp_path / "exported")

    Data.clear()
    mia.read_dicoms(folder_path=str(tmp_path / "exported"))
    img2 = Data.image["CT 01"]
    np.testing.assert_array_equal(img2.array, arr)
    np.testing.assert_allclose(img2.spacing, img.spacing)
    np.testing.assert_allclose(img2.origin, img.origin)


def test_ingest_determinism(tmp_path, rng):
    """Two ingests of the same archive produce identical registries
    (the bounded thread pool is order-deterministic; SURVEY.md §5)."""
    for s in range(3):
        arr = rng.integers(0, 500, size=(4, 12, 12)).astype(np.int16)
        write_ct_series(tmp_path / f"s{s}", arr)
    mia.read_dicoms(folder_path=str(tmp_path))
    first = {n: Data.image[n].array.copy() for n in Data.image_list}
    first_order = list(Data.image_list)
    mia.read_dicoms(folder_path=str(tmp_path))
    assert list(Data.image_list) == first_order
    for n in first:
        np.testing.assert_array_equal(Data.image[n].array, first[n])


def test_dvh_curve(tmp_path, rng):
    from helpers import square_contour_mm, write_rtstruct
    from test_deformable_dose import write_rtdose_file
    arr = rng.integers(-500, 500, size=(6, 16, 16)).astype(np.int16)
    info = write_ct_series(tmp_path / "ct", arr, spacing=(1, 1),
                           thickness=2.0)
    rois = {"T": [(square_contour_mm(info, z, 4, 10), z)
                  for z in range(2, 4)]}
    write_rtstruct(tmp_path / "ct" / "rs.dcm", info, rois)
    dose_raw = np.full((6, 16, 16), 40000, np.uint32)  # uniform 40 Gy
    write_rtdose_file(tmp_path / "ct" / "rd.dcm", dose_raw, info)
    mia.read_dicoms(folder_path=str(tmp_path))
    bins, vol = Data.dose["RTDOSE 01"].compute_dvh_curve("CT 01", "T")
    assert vol[0] == pytest.approx(100.0)
    assert vol[-1] == pytest.approx(0.0, abs=1.0)
    # step at 40 Gy
    assert vol[np.searchsorted(bins, 39.0)] > 95.0


def test_enhanced_multiframe_ct(tmp_path, rng):
    """Single enhanced CT file with per-frame positions assembles into
    the same volume a classic slice series would (NEW capability)."""
    from medicalimageanalysis_tpu.dicom import (Dataset, Sequence,
                                                dcmwrite, generate_uid,
                                                uids)
    arr = rng.integers(0, 2000, size=(6, 16, 16)).astype(np.uint16)
    ds = Dataset()
    ds.SOPClassUID = uids.CTImageStorage
    ds.SOPInstanceUID = generate_uid()
    ds.Modality = "CT"
    ds.PatientID = "E"
    ds.SeriesInstanceUID = generate_uid()
    ds.FrameOfReferenceUID = generate_uid()
    ds.NumberOfFrames = 6
    ds.Rows, ds.Columns = 16, 16
    ds.BitsAllocated = 16
    ds.BitsStored = 16
    ds.HighBit = 15
    ds.PixelRepresentation = 0
    ds.SamplesPerPixel = 1
    ds.PhotometricInterpretation = "MONOCHROME2"
    ds.SliceThickness = 2.0

    plane_orient = Dataset()
    plane_orient.ImageOrientationPatient = [1, 0, 0, 0, 1, 0]
    measures = Dataset()
    measures.PixelSpacing = [0.5, 0.5]
    measures.SliceThickness = 2.0
    transform = Dataset()
    transform.RescaleSlope = 1.0
    transform.RescaleIntercept = -1024.0
    shared = Dataset()
    shared.PlaneOrientationSequence = Sequence([plane_orient])
    shared.PixelMeasuresSequence = Sequence([measures])
    shared.PixelValueTransformationSequence = Sequence([transform])
    ds.SharedFunctionalGroupsSequence = Sequence([shared])

    per_frame = Sequence()
    for i in range(6):
        pos = Dataset()
        pos.ImagePositionPatient = [-50.0, -60.0, -10.0 + 2.0 * i]
        fg = Dataset()
        fg.PlanePositionSequence = Sequence([pos])
        per_frame.append(fg)
    ds.PerFrameFunctionalGroupsSequence = per_frame
    ds.PixelData = arr.astype("<u2").tobytes()

    (tmp_path / "e").mkdir()
    dcmwrite(tmp_path / "e" / "enhanced.dcm", ds)

    mia.read_dicoms(folder_path=str(tmp_path))
    assert Data.image_list == ["CT 01"]
    img = Data.image["CT 01"]
    assert img.array.shape == (6, 16, 16)
    np.testing.assert_array_equal(
        img.array, arr.astype(np.int16) - 1024)
    np.testing.assert_allclose(img.spacing, [0.5, 0.5, 2.0])
    np.testing.assert_allclose(img.origin, [-50.0, -60.0, -10.0])
    assert len(img.sops) == 6


def test_save_rois_create_main_folder(tmp_path, rng):
    """save_rois(create_main_folder=True) nests under the image name
    (reference structure/image.py:747-767 semantics)."""
    from helpers import square_contour_mm, write_rtstruct
    arr = rng.integers(0, 100, size=(4, 16, 16)).astype(np.int16)
    info = write_ct_series(tmp_path / "ct", arr)
    write_rtstruct(tmp_path / "ct" / "rs.dcm", info,
                   {"PTV": [(square_contour_mm(info, 1, 4, 10), 1)]})
    mia.read_dicoms(folder_path=str(tmp_path))
    img = Data.image["CT 01"]
    img.save_rois(str(tmp_path / "out"), create_main_folder=True)
    base = tmp_path / "out" / "CT 01" / "rois" / "PTV"
    assert (base / "roi.json").exists()
    assert (base / "contour_0000.npy").exists()
    # flat layout without the flag
    img.save_rois(str(tmp_path / "flat"))
    assert (tmp_path / "flat" / "rois" / "PTV" / "roi.json").exists()


def test_runtime_cache_respects_existing():
    """setup_jax_cache never overrides a user-configured cache dir
    (bench.py relies on this ordering)."""
    import jax
    from medicalimageanalysis_tpu import runtime
    # conftest/ops import already ran setup once; the configured dir
    # must be stable across repeat calls
    before = jax.config.jax_compilation_cache_dir
    runtime._done = False
    runtime.setup_jax_cache()
    assert jax.config.jax_compilation_cache_dir == before
    assert before is not None


def test_mhd_corrupt_raises_clean_valueerror(tmp_path, rng):
    """Corrupt MHD headers/payloads must raise ValueError naming the
    file, not whatever KeyError/TypeError/zlib error the parse hit
    (byte-flip fuzz finding)."""
    from medicalimageanalysis_tpu.read.mhd import (read_mhd_volume,
                                                   write_mhd_volume)

    vol = rng.normal(size=(4, 8, 8)).astype(np.float32)
    p = tmp_path / "v.mhd"
    write_mhd_volume(str(p), vol, spacing=[1, 1, 2], origin=[0, 0, 0])
    good = p.read_bytes()
    for trial in range(60):
        blob = bytearray(good)
        for _ in range(int(rng.integers(1, 10))):
            blob[int(rng.integers(0, len(blob)))] = int(
                rng.integers(0, 256))
        p.write_bytes(bytes(blob))
        try:
            read_mhd_volume(str(p))
        except (ValueError, FileNotFoundError):
            pass  # the typed-error contract
    # valid file still reads
    p.write_bytes(good)
    arr, sp, o, d = read_mhd_volume(str(p))
    np.testing.assert_allclose(arr, vol)


def test_mhd_roi_branch(tmp_path, rng):
    """read_mhd(roi_name=..., reference_name=...) attaches the MHD
    volume as an ROI mask on the target image (the reference reserved
    this branch as a `pass` stub, read/mhd.py:198-205)."""
    from medicalimageanalysis_tpu.read.mhd import write_mhd_volume

    arr = (rng.normal(0, 50, (6, 16, 16)).astype(np.float32)
           .astype(np.int16))
    write_ct_series(tmp_path / "ct", arr, spacing=(1, 1), thickness=2.0)
    mia.read_dicoms(folder_path=str(tmp_path / "ct"), clear=True)
    name = Data.image_list[0]
    image = Data.image[name]

    mask = np.zeros(arr.shape, np.uint8)
    mask[2:5, 4:12, 5:13] = 1
    p = tmp_path / "roi.mhd"
    write_mhd_volume(str(p), mask, spacing=image.spacing,
                     origin=image.origin)
    mia.read_mhd(file=str(p), reference_name=name, roi_name="Liver")
    assert "Liver" in image.rois
    got = image.rois["Liver"].compute_mask()
    # mask -> contour -> mask round trip loses at most the boundary
    assert (got & mask.astype(bool)).sum() > 0.8 * mask.sum()

    # label-volume variant with two labels
    labels = np.zeros(arr.shape, np.uint8)
    labels[1:3, 2:8, 2:8] = 1
    labels[4:6, 8:14, 8:14] = 2
    p2 = tmp_path / "labels.mhd"
    write_mhd_volume(str(p2), labels, spacing=image.spacing,
                     origin=image.origin)
    mia.read_mhd(file=str(p2), reference_name=name,
                 roi_names=["A", "B"])
    assert "A" in image.rois and "B" in image.rois

    # mismatched grid raises a clean error
    bad = np.zeros((3, 4, 4), np.uint8)
    p3 = tmp_path / "bad.mhd"
    write_mhd_volume(str(p3), bad, spacing=[1, 1, 1], origin=[0, 0, 0])
    with pytest.raises(ValueError, match="does not match"):
        mia.read_mhd(file=str(p3), reference_name=name, roi_name="X")


def test_mhd_dose_branch(tmp_path, rng):
    """read_mhd(dose=..., reference_name=...) registers the MHD volume
    as a Dose grid (the reference reserved this branch as a `pass`
    stub, read/mhd.py:207-212)."""
    from medicalimageanalysis_tpu.read.mhd import write_mhd_volume

    arr = np.zeros((6, 16, 16), np.int16)
    write_ct_series(tmp_path / "ct", arr, spacing=(1, 1), thickness=2.0)
    mia.read_dicoms(folder_path=str(tmp_path / "ct"), clear=True)
    name = Data.image_list[0]

    dose_vals = rng.uniform(0, 70, (6, 16, 16)).astype(np.float32)
    p = tmp_path / "dose.mhd"
    write_mhd_volume(str(p), dose_vals, spacing=[1, 1, 2],
                     origin=[0, 0, 0])
    mia.read_mhd(file=str(p), reference_name=name, dose=True)
    assert len(Data.dose_list) == 1
    dose = Data.dose[Data.dose_list[0]]
    np.testing.assert_allclose(dose.array, dose_vals)
    assert dose.frame_ref == Data.image[name].frame_ref
    stats = dose.compute_dose_statistics()
    assert abs(stats["max"] - dose_vals.max()) < 1e-5

    # scaling factor honored
    mia.read_mhd(file=str(p), reference_name=name, dose=0.5,
                 dose_name="half")
    np.testing.assert_allclose(Data.dose["half"].array,
                               dose_vals * 0.5, rtol=1e-6)


def test_ybr422_raw_color_us(tmp_path, rng):
    """Raw YBR_FULL_422 (2 stored samples/pixel: Y0 Y1 Cb Cr) expands
    to RGB; the plain samples=3 reshape would demand 50% more bytes
    than the file carries. End-to-end, ReadUS keeps the gray echo
    (Cb=Cr=128 -> R=G=B=Y exactly) and zeroes the colored overlay."""
    from medicalimageanalysis_tpu.dicom import (Dataset, dcmwrite,
                                                generate_uid, uids)
    from medicalimageanalysis_tpu.dicom.pixels import decode_pixel_data

    frames, rows, cols = 2, 16, 16
    y = rng.integers(30, 220, size=(frames, rows, cols)).astype(np.uint8)
    cb = np.full((frames, rows, cols // 2), 128, np.uint8)
    cr = np.full_like(cb, 128)
    cb[:, :4, :2] = 200                       # Doppler-style overlay
    quads = np.empty((frames, rows, cols // 2, 4), np.uint8)
    quads[..., 0] = y[..., 0::2]
    quads[..., 1] = y[..., 1::2]
    quads[..., 2] = cb
    quads[..., 3] = cr

    ds = Dataset()
    ds.SOPClassUID = uids.USImageStorage
    ds.SOPInstanceUID = generate_uid()
    ds.Modality = "US"
    ds.PatientID = "U422"
    ds.NumberOfFrames = frames
    ds.Rows, ds.Columns = rows, cols
    ds.BitsAllocated = 8
    ds.BitsStored = 8
    ds.HighBit = 7
    ds.PixelRepresentation = 0
    ds.SamplesPerPixel = 3
    ds.PlanarConfiguration = 0
    ds.PhotometricInterpretation = "YBR_FULL_422"
    ds.PixelData = quads.tobytes()
    (tmp_path / "us").mkdir()
    dcmwrite(tmp_path / "us" / "c.dcm", ds)

    from medicalimageanalysis_tpu.dicom.parser import dcmread
    rgb = decode_pixel_data(dcmread(tmp_path / "us" / "c.dcm"))
    assert rgb.shape == (frames, rows, cols, 3)
    # neutral-chroma region converts to exact gray
    np.testing.assert_array_equal(rgb[:, 4:, :, 0], y[:, 4:, :])
    assert (np.std(rgb[:, 4:, :, :].astype(float), axis=-1) == 0).all()
    # overlay region is non-uniform color
    assert (np.std(rgb[:, :4, :4, :].astype(float), axis=-1) > 0).all()

    mia.read_dicoms(folder_path=str(tmp_path))
    arr = Data.image[Data.image_list[0]].array
    np.testing.assert_array_equal(arr[:, 4:, :], y[:, 4:, :])
    assert (arr[:, :4, :4] == 0).all()


def test_ybr_full_matches_cv2(rng):
    """ybr_full_to_rgb is full-range BT.601 — cross-check against
    cv2.cvtColor (YCrCb order there) within rounding."""
    import cv2

    from medicalimageanalysis_tpu.dicom.pixels import ybr_full_to_rgb

    ybr = rng.integers(0, 256, size=(32, 32, 3)).astype(np.uint8)
    ours = ybr_full_to_rgb(ybr)
    ycrcb = ybr[..., [0, 2, 1]]
    ref = cv2.cvtColor(ycrcb, cv2.COLOR_YCrCb2RGB)
    assert np.abs(ours.astype(int) - ref.astype(int)).max() <= 1


def test_palette_color_lut(rng):
    """PALETTE COLOR expansion: plain 16-bit LUTs and the segmented
    discrete+linear form (PS3.3 C.7.9)."""
    from medicalimageanalysis_tpu.dicom import Dataset
    from medicalimageanalysis_tpu.dicom.pixels import \
        apply_palette_color_lut

    idx = rng.integers(0, 256, size=(10, 12)).astype(np.uint8)
    luts = {"Red": np.arange(256, dtype=np.uint16) * 257,
            "Green": (255 - np.arange(256, dtype=np.uint16)) * 257,
            "Blue": rng.integers(0, 65536, 256).astype(np.uint16)}
    ds = Dataset()
    ds.Rows, ds.Columns = idx.shape
    ds.BitsAllocated = 8
    ds.BitsStored = 8
    ds.SamplesPerPixel = 1
    ds.PhotometricInterpretation = "PALETTE COLOR"
    ds.RedPaletteColorLookupTableDescriptor = [256, 0, 16]
    ds.GreenPaletteColorLookupTableDescriptor = [256, 0, 16]
    ds.BluePaletteColorLookupTableDescriptor = [256, 0, 16]
    ds.RedPaletteColorLookupTableData = luts["Red"].tobytes()
    ds.GreenPaletteColorLookupTableData = luts["Green"].tobytes()
    ds.BluePaletteColorLookupTableData = luts["Blue"].tobytes()
    out = apply_palette_color_lut(ds, idx)
    assert out.shape == (10, 12, 3)
    np.testing.assert_array_equal(out[..., 0], luts["Red"][idx])
    np.testing.assert_array_equal(out[..., 2], luts["Blue"][idx])

    # segmented: discrete {0} then a 255-long linear ramp to 65535
    seg = np.array([0, 1, 0, 1, 255, 65535], dtype="<u2").tobytes()
    ds2 = Dataset()
    ds2.RedPaletteColorLookupTableDescriptor = [256, 0, 16]
    ds2.GreenPaletteColorLookupTableDescriptor = [256, 0, 16]
    ds2.BluePaletteColorLookupTableDescriptor = [256, 0, 16]
    ds2.SegmentedRedPaletteColorLookupTableData = seg
    ds2.SegmentedGreenPaletteColorLookupTableData = seg
    ds2.SegmentedBluePaletteColorLookupTableData = seg
    ds2.BitsStored = 8
    out2 = apply_palette_color_lut(ds2, idx)
    ramp = np.round(np.arange(256) * 65535 / 255).astype(np.uint16)
    np.testing.assert_array_equal(out2[..., 1], ramp[idx])
