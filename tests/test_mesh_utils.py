"""Mesh refinement utilities + remaining converter coverage."""

import numpy as np
import pytest

import medicalimageanalysis_tpu as mia
from medicalimageanalysis_tpu.data import Data
from medicalimageanalysis_tpu.ops.marching_cubes import marching_cubes_mask
from medicalimageanalysis_tpu.utils.mesh.surface import (
    Refinement, clean_mesh, expansion, only_main_component,
    surface_boundary, taubin_smooth, vertex_normals)
from medicalimageanalysis_tpu.utils.mesh.trimesh import TriMesh, box_mesh


def ball_mesh(r=6, n=16):
    mask = np.zeros((n, n, n), np.uint8)
    zz, yy, xx = np.mgrid[0:n, 0:n, 0:n]
    c = n / 2 - 0.5
    mask[(zz - c) ** 2 + (yy - c) ** 2 + (xx - c) ** 2 <= r * r] = 1
    return marching_cubes_mask(mask)


def test_taubin_smooth_preserves_volume():
    mesh = ball_mesh()
    smoothed = taubin_smooth(mesh, iterations=20, passband=0.1)
    assert smoothed.number_of_points == mesh.number_of_points
    # low-pass smoothing should not collapse the ball
    assert smoothed.volume > 0.7 * mesh.volume
    # blocky marching-tets surface gets smoother: area decreases
    assert smoothed.area < mesh.area


def test_refinement_cluster_and_decimate():
    mesh = ball_mesh()
    ref = Refinement(mesh)
    clustered = ref.cluster(points=100)
    assert clustered.number_of_points <= 160
    ref2 = Refinement(ball_mesh())
    decimated = ref2.decimate()  # heuristic 10*sqrt(N)
    assert decimated.number_of_points < ball_mesh().number_of_points


def test_tri_split_increases_faces():
    mesh = ball_mesh()
    ref = Refinement(mesh)
    split = ref.tri_split()
    assert split.number_of_faces > mesh.number_of_faces


def test_clean_mesh_fills_hole():
    box = box_mesh([0, 0, 0], [4, 4, 4])
    holey = TriMesh(box.points, box.faces[:-1])  # drop one face
    fixed = clean_mesh(holey)
    # watertight again: every edge shared by exactly 2 faces
    f = fixed.faces
    edges = np.sort(np.concatenate(
        [f[:, [0, 1]], f[:, [1, 2]], f[:, [2, 0]]]), axis=1)
    _, counts = np.unique(edges, axis=0, return_counts=True)
    assert (counts == 2).all()


def test_expansion_grows_volume():
    mesh = ball_mesh()
    bigger = expansion(mesh, 1.0)
    assert bigger.volume > mesh.volume


def test_vertex_normals_outward():
    box = box_mesh([0, 0, 0], [2, 2, 2])
    n = vertex_normals(box)
    center = np.array([1, 1, 1])
    outward = np.einsum("ij,ij->i", n, box.points - center)
    assert (outward > 0).all()


def test_surface_boundary_equal_counts():
    a = ball_mesh()
    b = ball_mesh(r=5)
    (sa,), (ta,) = surface_boundary([a], [b], [80])
    assert sa.number_of_points == ta.number_of_points


def test_only_main_component_single():
    mesh = ball_mesh()
    assert only_main_component(mesh) is mesh


def test_contour_to_mask_from_positions(tmp_path, rng):
    from medicalimageanalysis_tpu.utils.convert.contour import (
        ContourToMask)
    square = np.array([[2.0, 2.0, 4.0], [10.0, 2.0, 4.0],
                       [10.0, 10.0, 4.0], [2.0, 10.0, 4.0]])
    c2m = ContourToMask(contour_position=[square],
                        spacing=[1, 1, 2], origin=[0, 0, 0],
                        dimensions=[4, 16, 16], matrix=np.eye(3))
    mask = c2m.create_mask()
    expected = np.zeros((4, 16, 16), np.uint8)
    expected[2, 2:11, 2:11] = 1
    np.testing.assert_array_equal(mask, expected)


def test_us_regions_spacing(tmp_path, rng):
    from medicalimageanalysis_tpu.dicom import (Dataset, Sequence,
                                                dcmwrite, generate_uid,
                                                uids)
    frames = rng.integers(0, 255, size=(8, 8)).astype(np.uint8)
    ds = Dataset()
    ds.SOPClassUID = uids.USImageStorage
    ds.SOPInstanceUID = generate_uid()
    ds.Modality = "US"
    ds.PatientID = "U"
    ds.Rows, ds.Columns = 8, 8
    ds.BitsAllocated = 8
    ds.BitsStored = 8
    ds.HighBit = 7
    ds.PixelRepresentation = 0
    ds.SamplesPerPixel = 1
    ds.PhotometricInterpretation = "MONOCHROME2"
    region = Dataset()
    region.PhysicalDeltaX = 0.012
    region.PhysicalDeltaY = 0.034
    ds.SequenceOfUltrasoundRegions = Sequence([region])
    ds.PixelData = frames.tobytes()
    (tmp_path / "us").mkdir()
    dcmwrite(tmp_path / "us" / "us.dcm", ds)
    mia.read_dicoms(folder_path=str(tmp_path))
    img = Data.image["US 01"]
    # PhysicalDelta * 10, rounded to 4 dp (reference read/dicom.py:1377)
    np.testing.assert_allclose(img.spacing, [0.12, 0.34, 1.0])


def test_roi_mesh_slice_pixels(tmp_path, rng):
    from helpers import square_contour_mm, write_ct_series, write_rtstruct
    arr = rng.integers(0, 100, size=(8, 24, 24)).astype(np.int16)
    info = write_ct_series(tmp_path / "ct", arr, spacing=(1, 1),
                           thickness=2.0)
    rois = {"Box": [(square_contour_mm(info, z, 6, 16), z)
                    for z in range(2, 6)]}
    write_rtstruct(tmp_path / "ct" / "rs.dcm", info, rois)
    mia.read_dicoms(folder_path=str(tmp_path))
    roi = Data.image["CT 01"].rois["Box"]
    roi.create_discrete_mesh()
    loc = roi.mesh.center
    loops, colors = roi.compute_mesh_slice(
        location=loc, slice_plane="Axial", return_pixel=True)
    assert len(loops) >= 1
    pts = np.concatenate(loops)
    # cross-section stays inside the box footprint (pixels 6..16 +- 1)
    assert pts[:, 0].min() >= 4 and pts[:, 0].max() <= 18


def test_binary_host_mc_matches_device_pipeline():
    """The table-driven host path for 0/1 masks must be bit-identical
    to the device emit pipeline it was generated from (same tet
    decomposition, slot order, orientation, weld ordering)."""
    import jax.numpy as jnp
    from medicalimageanalysis_tpu.ops.marching_cubes import (
        _active_cubes, _binary_mc_host, _bucket, _compact_tris,
        _emit_triangles)

    rng = np.random.default_rng(3)
    n = 18
    mask = np.zeros((n, n, n), np.uint8)
    zz, yy, xx = np.mgrid[0:n, 0:n, 0:n]
    c = n / 2 - 0.5
    mask[(zz - c) ** 2 + (yy - c) ** 2 + 0.5 * (xx - c) ** 2 <= 36] = 1
    # speckle: exercise odd corner patterns, not just smooth blobs
    mask ^= (rng.random((n, n, n)) < 0.02).astype(np.uint8)
    vol8 = np.pad(mask, 1)

    # device pipeline golden (emit -> compact -> quantized key weld)
    volj = jnp.asarray(vol8).astype(jnp.float32)
    active = np.asarray(_active_cubes(volj, jnp.float32(0.5)))
    coords = np.argwhere(active).astype(np.int32)
    K = coords.shape[0]
    Kb = _bucket(K)
    coords_pad = np.zeros((Kb, 3), np.int32)
    coords_pad[:K] = coords
    row_valid = np.zeros(Kb, bool)
    row_valid[:K] = True
    tris, valid = _emit_triangles(volj, jnp.asarray(coords_pad),
                                  jnp.asarray(row_valid),
                                  jnp.float32(0.5))
    nv = int(np.asarray(valid).sum())
    cap = _bucket(nv, step=1.25)
    compact = np.asarray(_compact_tris(tris, valid, cap, True))
    q = compact[:nv].reshape(-1, 3).astype(np.int64)
    keys = q[:, 0] | (q[:, 1] << 16) | (q[:, 2] << 32)
    uniq, inverse = np.unique(keys, return_inverse=True)
    g_points = np.stack([uniq & 0xFFFF, (uniq >> 16) & 0xFFFF,
                         uniq >> 32], axis=1).astype(np.float32) * 0.5
    g_points = g_points - 1.0          # pad shift
    g_faces = inverse.reshape(-1, 3).astype(np.int32)
    good = ((g_faces[:, 0] != g_faces[:, 1])
            & (g_faces[:, 1] != g_faces[:, 2])
            & (g_faces[:, 0] != g_faces[:, 2]))
    g_faces = g_faces[good]

    # _binary_mc_host now takes the UNPADDED mask (the one-voxel zero
    # border is virtual in the native path, np.pad'd in the numpy twin)
    mesh = _binary_mc_host(mask, pad=True)
    np.testing.assert_array_equal(mesh.points, g_points)
    np.testing.assert_array_equal(mesh.faces, g_faces)


def test_binary_host_mc_unpadded_border():
    """pad=False with the structure touching the volume border: the
    host path must match the device grid extent (open surface, no
    out-of-range indexing)."""
    from medicalimageanalysis_tpu.ops.marching_cubes import (
        _binary_mc_host, marching_cubes_mask)

    mask = np.zeros((6, 6, 6), np.uint8)
    mask[0:3, 2:6, 0:4] = 1
    mesh = _binary_mc_host(mask, pad=False)
    assert mesh.points.shape[0] > 0
    # interior crossings only: open box has fewer faces than the padded
    closed = marching_cubes_mask(mask, pad=True)
    assert closed.faces.shape[0] > mesh.faces.shape[0]


def test_compute_midpoints():
    """compute_midpoints returns the shortest-edge midpoints of the
    crowded faces with deduplicated sorted edge pairs (broken WIP in
    the reference, surface.py:207-251)."""
    mesh = ball_mesh()
    ref = Refinement(mesh)
    mids, edges = ref.compute_midpoints()
    assert mids.shape[0] == edges.shape[0] > 0
    assert edges.shape[1] == 2
    # edges sorted + unique
    assert (edges[:, 0] <= edges[:, 1]).all()
    assert np.unique(edges, axis=0).shape[0] == edges.shape[0]
    # every midpoint is the mean of its edge's endpoints
    pts = np.asarray(mesh.points)
    np.testing.assert_allclose(
        mids, (pts[edges[:, 0]] + pts[edges[:, 1]]) / 2, atol=1e-12)
    # each chosen edge belongs to a crowded face
    crowded = set(int(i) for i in ref.correct_faces)
    face_sets = [set(map(int, f)) for f in np.asarray(mesh.faces)]
    for e in edges:
        assert any(set(map(int, e)) <= face_sets[c] for c in crowded)


def _tri_quality(mesh):
    """(aspect ratios, areas): aspect = circumradius / (2 * inradius),
    1.0 for equilateral."""
    p = np.asarray(mesh.points)
    f = np.asarray(mesh.faces)
    a = np.linalg.norm(p[f[:, 1]] - p[f[:, 0]], axis=1)
    b = np.linalg.norm(p[f[:, 2]] - p[f[:, 1]], axis=1)
    c = np.linalg.norm(p[f[:, 0]] - p[f[:, 2]], axis=1)
    s = (a + b + c) / 2
    area = np.sqrt(np.maximum(s * (s - a) * (s - b) * (s - c), 1e-30))
    circum = a * b * c / (4 * area)
    inr = area / s
    return circum / (2 * inr), area


def test_acvd_cluster_quality():
    """ACVD clustering hits the pyacvd quality bar: exact point count,
    isotropic triangles (aspect/area CV), and strictly better isotropy
    than the round-2 uniform-grid clustering (VERDICT r2 next #5)."""
    from medicalimageanalysis_tpu.utils.mesh.surface import acvd_cluster

    mesh = ball_mesh(r=13, n=32)
    target = 400
    out = acvd_cluster(mesh, target)
    assert out.number_of_points == target
    aspect, area = _tri_quality(out)
    # pyacvd-class isotropy on a sphere: most triangles near-equilateral
    assert np.median(aspect) < 1.6, np.median(aspect)
    assert np.mean(aspect < 2.5) > 0.9
    assert area.std() / area.mean() < 0.6
    # volume preserved to a few percent
    assert abs(out.volume - mesh.volume) < 0.1 * mesh.volume

    grid = mesh.cluster_decimate(target, method="grid")
    g_aspect, g_area = _tri_quality(grid)
    assert np.median(aspect) < np.median(g_aspect)
    assert area.std() / area.mean() < g_area.std() / g_area.mean()


def test_refinement_cluster_uses_acvd():
    from medicalimageanalysis_tpu.utils.mesh.surface import Refinement

    mesh = ball_mesh(r=10, n=24)
    ref = Refinement(mesh)
    out = ref.cluster(points=200)
    assert out.number_of_points == 200


def test_self_intersection_repair():
    """Two interpenetrating spheres (off-lattice shift: a lattice-
    aligned shift makes every crossing degenerate and undetectable):
    intersections found, repair removes them all and stays watertight
    (pymeshfix-grade, VERDICT r2 next #5)."""
    from medicalimageanalysis_tpu.utils.mesh.surface import (
        _boundary_loops, find_self_intersections,
        remove_self_intersections)
    from medicalimageanalysis_tpu.utils.mesh.trimesh import TriMesh

    s1 = ball_mesh(r=5, n=14)
    s2 = ball_mesh(r=5, n=14)
    p2 = s2.points.copy()
    p2 += np.array([4.37, 0.21, 0.13])   # off-lattice overlap
    merged = TriMesh(
        np.concatenate([s1.points, p2]),
        np.concatenate([s1.faces, s2.faces + s1.number_of_points]))
    bad = find_self_intersections(merged)
    assert bad.size > 0
    fixed = remove_self_intersections(merged)
    assert find_self_intersections(fixed).size == 0
    assert len(_boundary_loops(fixed)) == 0   # watertight
    # a clean sphere has none to begin with
    assert find_self_intersections(s1).size == 0


def test_expansion_fixes_intersections():
    """Normal-offset expansion of a CONCAVE shape pinches in the
    concavity; the repair removes the self-intersections it creates
    (reference runs pymeshfix here, surface.py:281-308)."""
    from medicalimageanalysis_tpu.ops.marching_cubes import (
        marching_cubes_mask)
    from medicalimageanalysis_tpu.utils.mesh.surface import (
        expansion, find_self_intersections)

    # kidney-bean: sphere minus an off-center bite -> concave crease
    n = 22
    zz, yy, xx = np.mgrid[0:n, 0:n, 0:n]
    c = n / 2 - 0.5
    mask = ((zz - c) ** 2 + (yy - c) ** 2 + (xx - c) ** 2
            <= 8 ** 2).astype(np.uint8)
    mask[(zz - c) ** 2 + (yy - (c + 7)) ** 2 + (xx - c) ** 2
         <= 5 ** 2] = 0
    from medicalimageanalysis_tpu.utils.mesh.surface import taubin_smooth
    bean = taubin_smooth(marching_cubes_mask(mask), iterations=30,
                         passband=0.1)
    raw = expansion(bean, 1.0)
    out = expansion(bean, 1.0, fix_intersections=True)
    assert find_self_intersections(out).size == 0
    assert out.volume > 0.9 * bean.volume


def test_mc_path_auto_selection(monkeypatch):
    """marching_cubes_mask picks host table vs device emit+compact from
    the measured transfer rate (VERDICT r2 weak #4), and both paths
    produce the same surface."""
    import medicalimageanalysis_tpu.ops.marching_cubes as mc
    import medicalimageanalysis_tpu.runtime as rt

    mask = np.zeros((12, 20, 20), np.uint8)
    mask[3:9, 5:15, 5:15] = 1

    # slow transfers: host path
    monkeypatch.setattr(rt, "transfer_rate_bytes_per_s",
                        lambda force=False: 12e6)
    m1 = mc.marching_cubes_mask(mask)
    assert mc.last_mc_path == "host"

    # fast transfers (local PCIe): device path on non-cpu backends; on
    # the CPU test backend the selector must still choose host
    monkeypatch.setattr(rt, "transfer_rate_bytes_per_s",
                        lambda force=False: 8e9)
    m2 = mc.marching_cubes_mask(mask)
    import jax
    assert mc.last_mc_path == ("host" if jax.default_backend() == "cpu"
                               else "device")

    # force the float/device pipeline on CPU via a non-0.5 iso and
    # check surface equivalence with the table path (same tessellation
    # family: equal volume + area to rounding)
    m3 = mc.marching_cubes_mask(mask.astype(np.float32), iso=0.5)
    assert abs(m3.volume - m1.volume) < 1e-3 * max(m1.volume, 1)
    assert abs(m3.area - m1.area) < 1e-3 * max(m1.area, 1)


def test_tet_stuffing_quality():
    """Isosurface-stuffing tet mesher hits the pytetwild-class bar
    (VERDICT r2 missing #3): boundary-conforming volume (within a few
    percent, vs the voxel mesher's staircase undershoot) and
    sliver-free elements (min dihedral above the filter, median at the
    BCC 60-degree optimum)."""
    from medicalimageanalysis_tpu.utils.mesh.surface import taubin_smooth
    from medicalimageanalysis_tpu.utils.mesh.volume import Volume

    n = 28
    zz, yy, xx = np.mgrid[0:n, 0:n, 0:n]
    c = n / 2 - 0.5
    mask = ((zz - c) ** 2 + (yy - c) ** 2 + (xx - c) ** 2
            <= 100).astype(np.uint8)
    surf = taubin_smooth(marching_cubes_mask(mask), iterations=20,
                         passband=0.1)
    true_vol = surf.volume

    tm = Volume(surf).create(edge_length=0.05)        # stuffing default
    ang = tm.dihedral_angles()
    assert 0.94 * true_vol < tm.volume < 1.03 * true_vol
    assert ang.min() >= 8.0
    assert np.percentile(ang, 1) > 25.0
    assert 55.0 < np.median(ang) < 65.0

    vox = Volume(surf).create(edge_length=0.05, method="voxel")
    # conformity strictly better than the voxel mesher
    assert abs(tm.volume - true_vol) < abs(vox.volume - true_vol)

    # non-convex shape conformity (bean)
    mask2 = mask.copy()
    mask2[(zz - c) ** 2 + (yy - (c + 8)) ** 2 + (xx - c) ** 2
          <= 36] = 0
    surf2 = taubin_smooth(marching_cubes_mask(mask2), iterations=20,
                          passband=0.1)
    tm2 = Volume(surf2).create(edge_length=0.05)
    assert 0.90 * surf2.volume < tm2.volume < 1.05 * surf2.volume
    assert tm2.dihedral_angles().min() >= 8.0


def test_chain_segments_fast_path_matches_walk():
    """The vectorized all-degree-2 loop extraction and the CSR walk
    must be interchangeable: identical loops (order, direction, start
    point) on closed-loop inputs, and the walk must handle open
    chains + pinch nodes the fast path refuses."""
    import medicalimageanalysis_tpu.utils.mesh.trimesh as tmod

    rng = np.random.default_rng(3)
    # closed loops: random polygons chopped into shuffled segments
    for n_loops in (1, 3):
        segs = []
        for k in range(n_loops):
            nv = int(rng.integers(4, 40))
            ang = np.sort(rng.uniform(0, 2 * np.pi, nv))
            ring = np.stack([(10 * k) + np.cos(ang), np.sin(ang),
                             np.zeros(nv)], axis=1)
            for i in range(nv):
                segs.append((ring[i], ring[(i + 1) % nv]))
        order = rng.permutation(len(segs))
        segs = [segs[i] for i in order]
        fast = tmod._chain_segments(segs)
        old = tmod._chain_closed_loops
        tmod._chain_closed_loops = lambda *a: None   # force the walk
        try:
            walk = tmod._chain_segments(segs)
        finally:
            tmod._chain_closed_loops = old
        assert len(fast) == len(walk) == n_loops
        for f, w in zip(fast, walk):
            np.testing.assert_array_equal(f, w)

    # open chain: fast path must decline, walk must return one chain
    line = np.stack([np.arange(5.0), np.zeros(5), np.zeros(5)], axis=1)
    segs = [(line[i], line[i + 1]) for i in range(4)]
    loops = tmod._chain_segments(segs)
    assert len(loops) == 1 and loops[0].shape[0] == 5


def test_slice_plane_candidate_faces_identical():
    """Restricting slice_plane to precomputed z-span candidates (the
    ModelToMask bucketing) yields byte-identical loops."""
    from medicalimageanalysis_tpu.ops.marching_cubes import (
        marching_cubes_mask)

    zz, yy, xx = np.mgrid[:24, :48, :48]
    mask = (((zz - 12) / 8.0) ** 2 + ((yy - 24) / 15.0) ** 2
            + ((xx - 24) / 11.0) ** 2) <= 1.0
    mesh = marching_cubes_mask(mask.astype(np.uint8))
    fz = mesh.points[:, 2][mesh.faces]
    fmin, fmax = fz.min(axis=1), fz.max(axis=1)
    for s in (6.0, 12.0, 17.5):
        cands = np.where((fmin <= s) & (s < fmax))[0]
        full = mesh.slice_plane([0, 0, 1], [0, 0, s])
        sub = mesh.slice_plane([0, 0, 1], [0, 0, s],
                               candidate_faces=cands)
        assert len(full) == len(sub)
        for f, w in zip(full, sub):
            np.testing.assert_array_equal(f, w)


def test_model_to_mask_descending_slice_locations():
    """Descending slice locations (reachable via the convert=False
    manual pipeline) must voxelize correctly: the z-span bucketing is
    ascending-only and must fall back to full-face plane cuts instead
    of silently producing empty candidates (review finding)."""
    from medicalimageanalysis_tpu.ops.marching_cubes import (
        marching_cubes_mask)
    from medicalimageanalysis_tpu.utils.convert.contour import (
        ModelToMask)

    zz, yy, xx = np.mgrid[:20, :40, :40]
    mask = (((zz - 10) / 7.0) ** 2 + ((yy - 20) / 12.0) ** 2
            + ((xx - 20) / 9.0) ** 2) <= 1.0
    mesh = marching_cubes_mask(mask.astype(np.uint8))

    def manual(locs):
        m = ModelToMask([mesh], convert=False, empty_array=False)
        m.spacing = [1, 1, 1]
        m.bounds = [0, 39, 0, 39, 0, 19]
        m.origin = [0, 0, 0]
        m.slice_locations = locs
        m.dims = [len(locs), 40, 40]
        m.compute_contours()
        m.compute_mask()
        return m

    asc = manual(list(range(20)))
    dsc = manual(list(range(19, -1, -1)))
    assert (asc.mask != 0).sum() > 100
    np.testing.assert_array_equal(asc.mask, dsc.mask[::-1])


def test_voxelize_device_matches_host_twin():
    """Device ray-parity voxelizer (VERDICT r3 #1): bit-exact against
    the host f64 implementation across all three slicing planes, the
    big-face fallback class, and empty input."""
    from medicalimageanalysis_tpu.ops.marching_cubes import mask_to_mesh
    from medicalimageanalysis_tpu.ops.voxelize import voxelize_mesh_device
    from medicalimageanalysis_tpu.utils.convert.voxelize import (
        voxelize_mesh)

    zz, yy, xx = np.mgrid[0:20, 0:28, 0:24].astype(np.float64)
    blob = (((zz - 10) / 7) ** 2 + ((yy - 14) / 10) ** 2
            + ((xx - 12) / 8) ** 2) <= 1.0
    mesh = mask_to_mesh(blob.astype(np.uint8), [1.0, 1.0, 1.0],
                        [0.0, 0.0, 0.0], np.eye(3))
    pts = np.asarray(mesh.points, np.float64)
    dims = (20, 28, 24)
    for plane in ("Axial", "Coronal", "Sagittal"):
        gold = voxelize_mesh(pts, mesh.faces, dims, plane=plane)
        dev = voxelize_mesh_device(pts, mesh.faces, dims, plane=plane)
        assert gold.sum() > 100
        np.testing.assert_array_equal(dev, gold, err_msg=plane)

    # big-face fallback: a box of 12 huge triangles (window > 32).
    # INTEGER cap heights (z = 2.0 / 7.0 would sit exactly on voxel
    # centers) are exercised separately below — the f32 k_max tie rule
    # must match the host's f64 floor(wc - 1e-9) exactly there
    # (round-4 review finding: 632 differing voxels before the
    # anchored-wc + exact-integer-tie fix).
    corners = np.array([[2.2, 2.2, 2.3], [21.5, 2.2, 2.3],
                        [21.5, 25.4, 2.3], [2.2, 25.4, 2.3],
                        [2.2, 2.2, 17.6], [21.5, 2.2, 17.6],
                        [21.5, 25.4, 17.6], [2.2, 25.4, 17.6]])
    faces = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7],
                      [0, 1, 5], [0, 5, 4], [2, 3, 7], [2, 7, 6],
                      [1, 2, 6], [1, 6, 5], [3, 0, 4], [3, 4, 7]])
    gold = voxelize_mesh(corners, faces, dims)
    dev = voxelize_mesh_device(corners, faces, dims)
    assert gold.sum() > 1000
    np.testing.assert_array_equal(dev, gold)

    # mixed: box + blob mesh in one face soup (classes + fallback
    # combine by XOR)
    pts_mix = np.concatenate([corners + np.array([0.1, 0.2, 0.0]), pts])
    faces_mix = np.concatenate([faces, np.asarray(mesh.faces) + 8])
    gold = voxelize_mesh(pts_mix, faces_mix, dims)
    dev = voxelize_mesh_device(pts_mix, faces_mix, dims)
    np.testing.assert_array_equal(dev, gold)

    # integer-height flat caps: crossings exactly ON voxel centers
    corners_i = corners.copy()
    corners_i[:4, 2] = 2.0
    corners_i[4:, 2] = 7.0
    gold = voxelize_mesh(corners_i, faces, dims)
    dev = voxelize_mesh_device(corners_i, faces, dims)
    assert gold.sum() > 1000
    np.testing.assert_array_equal(dev, gold)

    # empty mesh
    dev = voxelize_mesh_device(np.zeros((0, 3)), np.zeros((0, 3), int),
                               dims)
    assert dev.sum() == 0


def test_voxelize_batch_matches_per_mesh_host():
    """Cohort voxelization: B meshes in one pooled device pass ==
    per-mesh host f64 voxelization, including a big-face member."""
    from medicalimageanalysis_tpu.ops.marching_cubes import mask_to_mesh
    from medicalimageanalysis_tpu.ops.voxelize import voxelize_batch
    from medicalimageanalysis_tpu.utils.convert.voxelize import (
        voxelize_mesh)

    dims = (14, 24, 26)
    meshes = []
    for b in range(3):
        zz, yy, xx = np.mgrid[0:14, 0:24, 0:26].astype(np.float64)
        blob = (((zz - 7) / (4 + b)) ** 2 + ((yy - 12) / 7) ** 2
                + ((xx - 11 - b) / 6) ** 2) <= 1.0
        m = mask_to_mesh(blob.astype(np.uint8), [1, 1, 1],
                         [0, 0, 0], np.eye(3))
        meshes.append((np.asarray(m.points, np.float64),
                       np.asarray(m.faces)))
    corners = np.array([[2.2, 2.2, 2.3], [21.5, 2.2, 2.3],
                        [21.5, 20.4, 2.3], [2.2, 20.4, 2.3],
                        [2.2, 2.2, 11.6], [21.5, 2.2, 11.6],
                        [21.5, 20.4, 11.6], [2.2, 20.4, 11.6]])
    faces = np.array([[0, 2, 1], [0, 3, 2], [4, 5, 6], [4, 6, 7],
                      [0, 1, 5], [0, 5, 4], [2, 3, 7], [2, 7, 6],
                      [1, 2, 6], [1, 6, 5], [3, 0, 4], [3, 4, 7]])
    meshes.append((corners, faces))

    for plane in ("Axial", "Coronal"):
        out = voxelize_batch(meshes, dims, plane=plane)
        assert out.shape == (4,) + dims
        for b, (pts, fcs) in enumerate(meshes):
            gold = voxelize_mesh(pts, fcs, dims, plane=plane)
            np.testing.assert_array_equal(out[b], gold,
                                          err_msg=f"{plane} mesh {b}")
