"""Benchmark: end-to-end CT ingest -> FFS -> resample -> mask throughput.

Measures the BASELINE.json north-star workload (series/sec): synthetic
CT series on disk -> DICOM parse + decode (host) -> fused device
pipeline (rescale + FFS + separable resample + Gaussian + threshold
mask). The cohort is processed in pipelined chunks: the async device
dispatch of chunk k overlaps the host parse of chunk k+1.

Prints the card's name and power limit, then ONE JSON line:
{"metric": ..., "value": N, "unit": "series/sec", "detail": {...},
 "device": {"platform": ..., "kind": ..., "count": N}}
Every timing ends in jax.block_until_ready. Needs an accelerator.
"""

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

N_SERIES = int(os.environ.get("BENCH_SERIES", 8))
N_SLICES = int(os.environ.get("BENCH_SLICES", 40))
SIZE = int(os.environ.get("BENCH_SIZE", 256))
# half-cohort chunks: the async device dispatch of one chunk overlaps
# the host parse of the next
CHUNK = int(os.environ.get("BENCH_CHUNK", max(1, N_SERIES // 2)))
# best-of-N: the timed section is end-to-end (disk -> host parse ->
# device); multiple passes de-noise host CPU contention
PASSES = int(os.environ.get("BENCH_PASSES", 5))
OUT_SHAPE = (N_SLICES, SIZE // 2, SIZE // 2)


def _marginal(run, lo, hi):
    """Best-of-2 per-unit marginal cost between two sweep points of
    the same program family (run(n) must force completion itself).

    Returns seconds-per-unit, or -1.0 when the larger point measured
    faster (noise larger than the marginal cost).
    """
    ts = {}
    for n in (lo, hi):
        run(n)  # compile/warm this variant, unmeasured
        best = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            run(n)
            best = min(best, time.perf_counter() - t0)
        ts[n] = best
    return (ts[hi] - ts[lo]) / (hi - lo) if ts[hi] > ts[lo] else -1.0


def main():
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import jax

    dev = jax.devices()[0]
    if dev.platform == "cpu":
        print("bench: no accelerator found", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True)
    print(smi.stdout.strip(), flush=True)

    import medicalimageanalysis_tpu as mia
    from medicalimageanalysis_tpu.config import config
    from medicalimageanalysis_tpu.data import Data
    from medicalimageanalysis_tpu.parallel.batch import make_preprocess_fn
    from medicalimageanalysis_tpu.utils.creation import CreateDicomImage

    # host assembles raw stacks; device work happens in the fused
    # batched program below (no per-series round trips)
    config.jit_ingest = False

    rng = np.random.default_rng(0)
    tmp = tempfile.mkdtemp(prefix="mia_bench_")
    series_dirs = []
    for s in range(N_SERIES):
        arr = rng.integers(0, 3000, size=(N_SLICES, SIZE, SIZE)) \
            .astype(np.int16)
        d = os.path.join(tmp, f"s{s:02d}")
        CreateDicomImage(d, arr, spacing=[0.97, 0.97],
                         thickness=2.5).run()
        series_dirs.append(d)

    import jax.numpy as jnp0
    from medicalimageanalysis_tpu.ops.bitpack import (pack12,
                                                      unpack12_device)

    pre = make_preprocess_fn((N_SLICES, SIZE, SIZE), OUT_SHAPE,
                             ffs_op="none")
    fn = jax.jit(pre)

    # packed-staging variant: CT pixels are <= 12-bit stored in int16 —
    # lossless 8-values-into-3-words packing cuts the host->device
    # bytes 25%; the device unpacks with static shifts fused into the
    # pipeline (ops/bitpack.py)
    @jax.jit
    def fn_packed(words, lo, sl, ic):
        raw = unpack12_device(words, lo, SIZE, dtype=jnp0.int16)
        return pre(raw, sl, ic)

    # warmup: compile ingest path + device pipeline outside timing
    mia.read_dicoms(folder_path=series_dirs[0])
    warm = fn(np.zeros((CHUNK, N_SLICES, SIZE, SIZE), np.int16),
              np.ones(CHUNK, np.float32), np.zeros(CHUNK, np.float32))
    jax.block_until_ready(warm)
    wp = pack12(np.zeros((CHUNK, N_SLICES, SIZE, SIZE), np.int16))
    warm = fn_packed(wp[0], np.float32(wp[1]),
                     np.ones(CHUNK, np.float32),
                     np.zeros(CHUNK, np.float32))
    jax.block_until_ready(warm)
    Data.clear()

    total, t_host, packed_hits = float("inf"), 0.0, 0
    staged_bytes = 0
    pass_times = []
    for _pass_i in range(PASSES):
        Data.clear()
        t0 = time.perf_counter()
        pending = []
        th_sum = 0.0
        hits = 0
        up_bytes = 0
        for c in range(0, N_SERIES, CHUNK):
            th = time.perf_counter()
            chunk_dirs = series_dirs[c:c + CHUNK]
            before = set(Data.image_list)
            # one call per chunk: the parser's pool spans all series
            chunk_files = [os.path.join(d, f) for d in chunk_dirs
                           for f in sorted(os.listdir(d))]
            mia.read_dicoms(file_list=chunk_files, clear=False)
            new_names = [n for n in Data.image_list if n not in before]
            batch = np.stack([Data.image[n].array for n in new_names])
            packed = pack12(batch)
            th_sum += time.perf_counter() - th
            ones = np.ones(batch.shape[0], np.float32)
            zeros = np.zeros(batch.shape[0], np.float32)
            # async dispatch: upload+compute overlap next chunk's parse
            if packed is not None and packed[2] == SIZE:
                hits += 1
                up_bytes += packed[0].nbytes
                pending.append(fn_packed(packed[0],
                                         np.float32(packed[1]),
                                         ones, zeros))
            else:
                up_bytes += batch.nbytes
                pending.append(fn(batch, ones, zeros))
            up_bytes += ones.nbytes + zeros.nbytes + 4
        jax.block_until_ready(pending)
        t_pass = time.perf_counter() - t0
        pass_times.append(t_pass)
        if t_pass < total:
            total, t_host, packed_hits = t_pass, th_sum, hits
            staged_bytes = up_bytes

    # secondary BASELINE target: rigid registration < 100 ms per CT<->CT
    # pair. One dispatch runs the whole multi-resolution descent on
    # device (models/rigid_intensity._register_level is a lax.scan).
    import jax.numpy as jnp
    from medicalimageanalysis_tpu.models.rigid_intensity import (
        _register_level)
    names = Data.image_list[:2]
    if len(names) < 2:
        names = [names[0], names[0]]  # self-registration fallback
    ref = Data.image[names[0]]
    mov = Data.image[names[1]]
    from medicalimageanalysis_tpu.ops import geometry as geo_ops
    # int16 as stored: halves the staged bytes (cast to f32 in-jit)
    ref_vol = jnp.asarray(ref.array)
    mov_vol = jnp.asarray(mov.array)
    r_p2p = jnp.asarray(geo_ops.pixel_to_position_matrix(
        ref.matrix, ref.spacing, ref.origin))
    m_pos2pix = jnp.asarray(geo_ops.position_to_pixel_matrix(
        mov.matrix, mov.spacing, mov.origin))
    center = jnp.asarray(np.asarray(ref.compute_center(), np.float32))
    pose0 = jnp.zeros(6, jnp.float32)
    args = (ref_vol, mov_vol, r_p2p, m_pos2pix, center, pose0,
            jnp.float32(0.1))
    jax.block_until_ready(
        _register_level(*args, steps=40, stride=(2, 2, 2)))  # warm
    t2 = time.perf_counter()
    jax.block_until_ready(_register_level(*args, steps=40, stride=(2, 2, 2)))
    reg_ms = (time.perf_counter() - t2) * 1000.0

    # marginal per-step cost: steps sweep inside the same one-scan
    # program, (t(240) - t(40)) / 200
    def _reg_run(st):
        jax.block_until_ready(
            _register_level(*args, steps=st, stride=(2, 2, 2)))
    reg_step = _marginal(_reg_run, 40, 240)
    reg_step_ms = reg_step * 1000.0 if reg_step > 0 else -1.0

    pull = jax.block_until_ready

    # deformable (demons) marginal per-iteration cost, device-resident
    # 64x128x128 pair, iters 5 vs 25 in the same fori_loop program
    from medicalimageanalysis_tpu.ops.registration.demons import (
        _demons_core)
    dz, dy, dx = 64, 128, 128
    rng_d = np.random.default_rng(1)
    fx_d = jax.device_put(jnp.asarray(
        rng_d.normal(size=(dz, dy, dx)).astype(np.float32)))
    mv_d = jax.device_put(jnp.asarray(
        rng_d.normal(size=(dz, dy, dx)).astype(np.float32)))
    sp_d = jax.device_put(jnp.asarray([1.0, 1.0, 1.0], jnp.float32))
    def _dem_run(it):
        pull(_demons_core(fx_d, mv_d, sp_d, 1.0, jnp.float32(2.0),
                          jnp.float32(0.001), it, "fast", True))
    dem_iter = _marginal(_dem_run, 5, 105)
    demons_iter_ms = dem_iter * 1000.0 if dem_iter > 0 else -1.0

    # config #1 transfer-free: the fused device pipeline with the batch
    # already resident in device memory
    names = Data.image_list[:N_SERIES]
    batch_h = np.stack([np.asarray(Data.image[n].array)
                        for n in names]).astype(np.int16)
    bpad = N_SERIES - batch_h.shape[0]
    if bpad > 0:
        batch_h = np.concatenate([batch_h] * (N_SERIES // len(names) + 1)
                                 )[:N_SERIES]
    bd = jax.device_put(batch_h)
    ones_b = jax.device_put(np.ones(N_SERIES, np.float32))
    zeros_b = jax.device_put(np.zeros(N_SERIES, np.float32))
    pull(fn(bd, ones_b, zeros_b))  # warm this batch shape
    t3 = time.perf_counter()
    pull(fn(bd, ones_b, zeros_b))
    onchip_s = time.perf_counter() - t3
    onchip_series_s = N_SERIES / onchip_s

    # the device-compute rate as the MARGINAL cost of one more batch
    # inside one program: fori_loop the pipeline with a counter-perturbed
    # input (so XLA cannot CSE the iterations) and take
    # (t(reps_hi) - t(reps_lo)) / (reps_hi - reps_lo)
    import jax.numpy as jnp_

    # CSE-blocker: perturb the f32 rescale SLOPE, not the raw batch —
    # slopes multiply every voxel (no iteration can be CSE'd) at zero
    # extra HBM traffic, whereas raw + (i % 2) forces a full
    # batch-sized int16 elementwise pass per iteration that swamps the
    # quantity under measurement
    def make_loop(reps):
        @jax.jit
        def loop(raw, sl, ic):
            def body(i, acc):
                out = fn(raw, sl + (i % 2).astype(sl.dtype), ic)
                # full-output reductions: consuming a single element
                # would let XLA dead-code-eliminate the pipeline
                return acc + jnp_.sum(out[0]) + jnp_.sum(out[1])
            return jax.lax.fori_loop(0, reps, body, jnp_.float32(0.0))
        return loop

    loops = {r: make_loop(r) for r in (2, 102)}
    marg = {}
    for r, lp in loops.items():
        pull(lp(bd, ones_b, zeros_b))
        best = float("inf")
        for _ in range(2):
            t = time.perf_counter()
            pull(lp(bd, ones_b, zeros_b))
            best = min(best, time.perf_counter() - t)
        marg[r] = best
    # same inversion contract as _marginal: -1 when noise exceeds the
    # marginal cost
    if marg[102] > marg[2]:
        onchip_marginal_series_s = N_SERIES * 100.0 / (marg[102]
                                                       - marg[2])
    else:
        onchip_marginal_series_s = -1.0

    # batch-scale sweep: every B measures a full streaming pass over a
    # 16 x N_SERIES device-resident pool, partitioned into pool/B
    # sequential B-batch bodies inside one program (each series is read
    # once per pass, as in a real cohort pass)
    batch_sweep = {}
    POOL_N = 16 * N_SERIES
    pool_dev = jnp_.tile(bd, (POOL_N // N_SERIES, 1, 1, 1))
    pool_dev.block_until_ready()
    for B in (N_SERIES, 4 * N_SERIES, 8 * N_SERIES, POOL_N):
        reps_hi = 12
        nwin = POOL_N // B
        onesB = jax.device_put(np.ones(B, np.float32))
        zerosB = jax.device_put(np.zeros(B, np.float32))
        preB = make_preprocess_fn((N_SLICES, SIZE, SIZE), OUT_SHAPE,
                                  ffs_op="none")

        def make_loopB(reps):
            @jax.jit
            def loop(pool, sl, ic):
                pw = pool.reshape(nwin, B, N_SLICES, SIZE, SIZE)
                def body(i, acc):
                    # slope perturbation: see make_loop above
                    def win(a, w):
                        out = preB(w, sl + (i % 2).astype(sl.dtype),
                                   ic)
                        return (a + jnp_.sum(out[0])
                                + jnp_.sum(out[1])), None
                    a2, _ = jax.lax.scan(win, acc, pw)
                    return a2
                return jax.lax.fori_loop(0, reps, body,
                                         jnp_.float32(0.0))
            return loop

        tB = {}
        for r in (2, reps_hi):
            lp = make_loopB(r)
            pull(lp(pool_dev, onesB, zerosB))
            best = float("inf")
            for _ in range(2):
                t = time.perf_counter()
                pull(lp(pool_dev, onesB, zerosB))
                best = min(best, time.perf_counter() - t)
            tB[r] = best
        per_rep = max((tB[reps_hi] - tB[2]) / (reps_hi - 2), 1e-9)
        batch_sweep[str(B)] = round(POOL_N / per_rep, 1)
    # the production-shaped number: the whole resident cohort in one
    # flat dispatch (what parallel.batch issues)
    onchip_pool_series_s = batch_sweep[str(POOL_N)]
    del pool_dev

    # config #2: RTSTRUCT contour -> mask rasterization, liver scale
    # (150 contours of 120 pts on a 120x512x512 grid), device XOR
    # rasterizer vs the bit-parity cv2 host backend
    from medicalimageanalysis_tpu.utils.convert.contour import (
        ContourToDiscreteMesh)
    # liver-scale ROI: one ~120-pt contour per slice over 100 slices,
    # plus a 50-slice second structure (reference workloads put one
    # closed planar contour per slice per ROI; overlapping same-slice
    # contours would XOR into thin shells and blow up the surface)
    theta = np.linspace(0, 2 * np.pi, 120, endpoint=False)
    contours = []
    for z in range(10, 110):
        r = 60 + 25 * np.sin(z / 9.0)
        cx_, cy_ = 256 + 30 * np.cos(z / 13.0), 256 + 20 * np.sin(z / 7.0)
        contours.append(np.stack(
            [cx_ + r * np.cos(theta), cy_ + r * np.sin(theta),
             np.full_like(theta, float(z))], axis=1))
    for z in range(30, 80):
        r = 14 + 4 * np.sin(z / 5.0)
        contours.append(np.stack(
            [420.0 + r * np.cos(theta), 130.0 + r * np.sin(theta),
             np.full_like(theta, float(z))], axis=1))
    dims_shw = [120, 512, 512]  # (slices, H, W)
    raster_ms = {}
    for backend_name in ("device", "cv2"):
        for timed in (False, True):  # warm compile first, then time
            t4 = time.perf_counter()
            c2m = ContourToDiscreteMesh(
                contour_pixel=[c.copy() for c in contours],
                dimensions=dims_shw, backend=backend_name)
            jax.block_until_ready(c2m.mask)
            if timed:
                raster_ms[backend_name] = \
                    (time.perf_counter() - t4) * 1000.0
    roi_mask = np.asarray(c2m.mask)  # cv2 pass ran last: host array

    # device rasterizer figure with the mask left on the device
    # (bbox-tile path)
    from medicalimageanalysis_tpu.ops.rasterize import _pooled_canvas
    from medicalimageanalysis_tpu.utils.convert.contour import _plane_split
    polys2d, slice_idx = _plane_split(contours, "Axial")
    sidx = np.asarray(slice_idx, np.int32)
    targets1 = np.where((sidx >= 0) & (sidx < dims_shw[0]), sidx,
                        dims_shw[0]).astype(np.int32)
    raster_onchip_ms = float("inf")
    for timed in (False, True, True):
        t4b = time.perf_counter()
        out_m = _pooled_canvas(polys2d, targets1, dims_shw[0], 512, 512)
        jax.block_until_ready(out_m)
        if timed:
            raster_onchip_ms = min(raster_onchip_ms,
                                   (time.perf_counter() - t4b) * 1000.0)

    # cohort rasterization (VERDICT r3 #1): ALL contours of 8 ROIs in
    # ONE pooled device pass; the per-ROI marginal is the number that
    # beats cv2's per-ROI cost at cohort scale
    RASTER_B = 8
    pool_polys = []
    pool_targets = []
    for b in range(RASTER_B):
        pool_polys.extend(polys2d)
        pool_targets.extend((b * dims_shw[0] + targets1).tolist())
    pool_targets = np.asarray(pool_targets, np.int32)
    raster_batch_ms = float("inf")
    for timed in (False, True, True):
        t4c = time.perf_counter()
        out_b = _pooled_canvas(pool_polys, pool_targets,
                               RASTER_B * dims_shw[0], 512, 512)
        jax.block_until_ready(out_b)
        if timed:
            raster_batch_ms = min(raster_batch_ms,
                                  (time.perf_counter() - t4c) * 1000.0)
    raster_batch_per_roi_ms = raster_batch_ms / RASTER_B

    # the SERVING path for VERDICT r4 #3: Roi.compute_mask routes a
    # structure set's first miss through Image.compute_roi_masks (one
    # pooled pass on the device rasterizer)
    # and caches bbox-cropped bit-packed masks; later masks cost one
    # unpack. Timed on a real ingested Image with 8 fresh ROIs — NOT a
    # re-emit of the resident-canvas row above.
    from medicalimageanalysis_tpu.structure.roi import Roi as _Roi
    pooled_img = Data.image[Data.image_list[0]]
    pz, ph, pw = (int(v) for v in pooled_img.dimensions)
    pooled_names = []
    for k in range(RASTER_B):
        rname = f"_bench_pooled_{k}"
        pr = _Roi(pooled_img, name=rname)
        cs = []
        for z in range(2, pz - 2):
            rr = min(ph, pw) * (0.12 + 0.02 * ((k + z) % 4))
            cxk = pw * 0.5 + 10 * k
            cyk = ph * 0.5 - 6 * k
            cs.append(np.stack(
                [cxk + rr * np.cos(theta), cyk + rr * np.sin(theta),
                 np.full_like(theta, float(z))], axis=1))
        pr.contour_pixel = cs
        pooled_img.rois[rname] = pr
        pooled_names.append(rname)
    n_pool_group = sum(
        1 for r in pooled_img.rois.values()
        if r.contour_pixel is not None and len(r.contour_pixel))
    t4d = time.perf_counter()
    pooled_masks = pooled_img.rois[pooled_names[0]].compute_mask()
    raster_pooled_first_ms = (time.perf_counter() - t4d) * 1000.0
    raster_pooled_per_roi_ms = raster_pooled_first_ms / n_pool_group
    t4e = time.perf_counter()
    for rname in pooled_names[1:]:
        pooled_img.rois[rname].compute_mask()
    raster_cache_hit_ms = ((time.perf_counter() - t4e) * 1000.0
                           / (RASTER_B - 1))
    assert int(pooled_masks.max()) == 1, "pooled bench mask is empty"
    for rname in pooled_names:
        del pooled_img.rois[rname]

    # config #3: batched isotropic resample + Gaussian over the cohort
    from medicalimageanalysis_tpu.ops.filters import _gauss_kernel_matrix
    from medicalimageanalysis_tpu.ops.resample import _interp_matrix

    @jax.jit
    def resample_filter(b):
        b = b.astype(jnp.float32)
        _, Zi, Yi, Xi = b.shape
        Zo, Yo, Xo = OUT_SHAPE
        mz = jnp.asarray(_interp_matrix(Zo, Zi, Zi / Zo))
        my = jnp.asarray(_interp_matrix(Yo, Yi, Yi / Yo))
        mx = jnp.asarray(_interp_matrix(Xo, Xi, Xi / Xo))
        gz = jnp.asarray(_gauss_kernel_matrix(Zo, 1.5))
        gy = jnp.asarray(_gauss_kernel_matrix(Yo, 1.5))
        gx = jnp.asarray(_gauss_kernel_matrix(Xo, 1.5))
        out = jnp.einsum("ij,bjyx->biyx", gz @ mz, b,
                         preferred_element_type=jnp.float32)
        out = jnp.einsum("kj,bzjx->bzkx", gy @ my, out,
                         preferred_element_type=jnp.float32)
        return jnp.einsum("lj,bzyj->bzyl", gx @ mx, out,
                          preferred_element_type=jnp.float32)

    pull(resample_filter(bd))
    t5 = time.perf_counter()
    pull(resample_filter(bd))
    resample_ms = (time.perf_counter() - t5) * 1000.0

    # config #5: mesh pipeline — device marching cubes on the config-#2
    # ROI mask, decimate (the reference 3MF flow decimates to ~50k pts,
    # mf3.py:215), then ModelToMask voxelization of the result
    from medicalimageanalysis_tpu.ops.marching_cubes import mask_to_mesh
    from medicalimageanalysis_tpu.utils.convert.contour import ModelToMask
    mask_to_mesh(roi_mask, [0.97, 0.97, 2.5], [0.0, 0.0, 0.0],
                 np.eye(3))  # warm the compile
    # best-of-3: host CPU contention swings identical runs; the min is
    # the reproducible figure
    mc_ms = float("inf")
    for _ in range(3):
        t6 = time.perf_counter()
        mesh = mask_to_mesh(roi_mask, [0.97, 0.97, 2.5], [0.0, 0.0, 0.0],
                            np.eye(3))
        mc_ms = min(mc_ms, (time.perf_counter() - t6) * 1000.0)
    frac = min(1.0, 50000.0 / max(mesh.points.shape[0], 1))
    mesh_d = mesh.decimate_pro(1.0 - frac) if frac < 1.0 else mesh
    voxelize_ms = float("inf")
    for _ in range(2):
        t7 = time.perf_counter()
        m2m = ModelToMask([mesh_d], empty_array=False)
        assert m2m.mask is not None
        voxelize_ms = min(voxelize_ms,
                          (time.perf_counter() - t7) * 1000.0)

    # exact ray-parity voxelization, host vs device (VERDICT r3 #1):
    # same mesh on the full 120x512x512 grid; the device figure leaves
    # the mask on the device; bit-exactness pinned in
    # tests/test_mesh_utils.py
    from medicalimageanalysis_tpu.ops.voxelize import voxelize_mesh_device
    from medicalimageanalysis_tpu.utils.convert.voxelize import (
        voxelize_mesh)
    pts_pixel = np.asarray(mesh_d.points, np.float64) \
        / np.array([0.97, 0.97, 2.5])
    vox_host_ms = float("inf")
    for _ in range(3):
        t7b = time.perf_counter()
        voxelize_mesh(pts_pixel, mesh_d.faces, (120, 512, 512),
                      backend="host")
        vox_host_ms = min(vox_host_ms,
                          (time.perf_counter() - t7b) * 1000.0)
    vox_dev_ms = float("inf")
    for timed in (False, True, True):
        t7c = time.perf_counter()
        dvm = voxelize_mesh_device(pts_pixel, mesh_d.faces,
                                   (120, 512, 512), as_numpy=False)
        jax.block_until_ready(dvm)
        if timed:
            vox_dev_ms = min(vox_dev_ms,
                             (time.perf_counter() - t7c) * 1000.0)
    # cohort scale: 8 meshes in ONE pooled device pass (scatter
    # histogram + batched parity scan); the per-mesh figure is the
    # number that beats the host at cohort scale
    from medicalimageanalysis_tpu.ops.voxelize import (
        voxelize_batch, voxelize_compute_marginal_ms)
    VOX_B = 8
    vmeshes = [(pts_pixel, np.asarray(mesh_d.faces))] * VOX_B
    vox_batch_ms = float("inf")
    vox_stats = {}
    for timed in (False, True, True):
        vox_stats = {}
        t7d = time.perf_counter()
        dvb = voxelize_batch(vmeshes, (120, 512, 512), as_numpy=False,
                             stats=vox_stats)
        jax.block_until_ready(dvb)
        if timed:
            vox_batch_ms = min(vox_batch_ms,
                               (time.perf_counter() - t7d) * 1000.0)
    vox_batch_per_mesh_ms = vox_batch_ms / VOX_B
    vox_compute_marginal_per_mesh_ms = voxelize_compute_marginal_ms(
        vmeshes, (120, 512, 512), iters=3) / VOX_B

    # affine reslice marginals over K scanned warps (perturbed
    # translations defeat CSE): a near-rigid map and a 45-degree oblique
    # one, both on the XLA gather path behind affine_resample
    from functools import partial as _partial

    from scipy.spatial.transform import Rotation as _Rot

    from medicalimageanalysis_tpu.ops.resample import _affine_resample_jit
    No = 128
    obl_vol = jax.device_put(
        np.random.default_rng(2).normal(size=(No, No, No))
        .astype(np.float32))
    _R = _Rot.from_euler("z", 45, degrees=True).as_matrix()
    _Ao = np.eye(4)
    _Ao[:3, :3] = _R
    _c = np.array([No / 2] * 3)
    _Ao[:3, 3] = _c - _R @ _c
    _Aa = np.eye(4)
    _Aa[:3, :3] += np.random.default_rng(5).normal(scale=0.01, size=(3, 3))
    _Aa[:3, 3] = [1.5, -2.0, 0.5]

    @_partial(jax.jit, static_argnames=("reps",))
    def reslice_scan(v, A, reps):
        def body(acc, i):
            a = A.at[0, 3].add(jnp.float32(i) * 1e-3)
            o = _affine_resample_jit(v, a, (No, No, No),
                                     jnp.float32(-3001.0))
            return acc + jnp.sum(o), None
        acc, _ = jax.lax.scan(body, jnp.float32(0.0), jnp.arange(reps))
        return acc

    def reslice_marginal(A):
        Aj = jnp.asarray(A, jnp.float32)
        s_ = _marginal(lambda reps: pull(reslice_scan(obl_vol, Aj, reps)),
                       2, 52)
        return (s_ * 1000.0, No ** 3 / s_ / 1e6) if s_ > 0 else (-1.0,
                                                                -1.0)

    oblique_ms, oblique_mpts = reslice_marginal(_Ao)
    affine_ms, affine_mpts = reslice_marginal(_Aa)

    # gamma dose-QA scan kernel (round-3 addition): clinical 3%/3mm
    # layout on a 64x100x100 2.5mm grid. Marginal discipline: the
    # offset list is runtime data, so timing the full list vs a
    # quarter of it (two compiles of the same body — scan length is
    # static) isolates the per-offset streaming cost from dispatch +
    # phase-carving overhead.
    from medicalimageanalysis_tpu.ops.gamma import (
        _decompose_offsets, _gamma_fn, fine_grid_layout,
        upsample_to_fine)
    gz, gy, gx = 64, 100, 100
    zzg, yyg, xxg = np.mgrid[0:gz, 0:gy, 0:gx]
    gref = (60.0 * np.exp(-(((zzg - 32) / 20.0) ** 2
                            + ((yyg - 50) / 30.0) ** 2
                            + ((xxg - 50) / 30.0) ** 2))
            ).astype(np.float32)
    gevl = gref * 1.02
    gs, gr, goffs, gd2 = fine_grid_layout([2.5, 2.5, 2.5], 3.0)
    gamma_noff = len(gd2)
    gfine = upsample_to_fine(jnp.asarray(gevl), gs, gr)
    grows = _decompose_offsets(goffs, gs, gr)
    gdd2 = np.float32((0.03 * 60.0) ** 2)
    gdta2 = jnp.float32(9.0)
    grefj = jnp.asarray(gref)
    gfn = _gamma_fn((gz, gy, gx), gs, gr, None)
    gt = {}
    for m in (gamma_noff // 4, gamma_noff):
        rows_m = jnp.asarray(grows[:m])
        d2_m = jnp.asarray(gd2[:m], jnp.float32)
        pull(gfn(grefj, gfine, gdd2, rows_m, d2_m, gdta2))
        t9 = time.perf_counter()
        pull(gfn(grefj, gfine, gdd2, rows_m, d2_m, gdta2))
        gt[m] = time.perf_counter() - t9
    gamma_full_ms = gt[gamma_noff] * 1000.0
    # noise guard like the reslice rows: -1.0 when the points invert
    gamma_marg_ms = (
        (gt[gamma_noff] - gt[gamma_noff // 4])
        / (gamma_noff - gamma_noff // 4) * gamma_noff * 1000.0
        if gt[gamma_noff] > gt[gamma_noff // 4] else -1.0)

    value = N_SERIES / total
    mc_path = __import__("medicalimageanalysis_tpu.ops.marching_cubes",
                         fromlist=["last_mc_path"]).last_mc_path
    print(json.dumps({
        "metric": "ct_ingest_ffs_resample_mask_throughput",
        "value": round(value, 3),
        "unit": "series/sec",
        "detail": {
            "n_series": N_SERIES, "slices": N_SLICES, "size": SIZE,
            "chunk": CHUNK, "total_s": round(total, 3),
            "host_s": round(t_host, 3),
            "passes": PASSES,
            "pass_times_s": [round(t, 3) for t in pass_times],
            "pass_std_s": round(float(np.std(pass_times)), 3),
            "staged_upload_mb": round(staged_bytes / 1e6, 2),
            "packed_upload_chunks": packed_hits,
            "onchip_batch_sweep_series_per_s": batch_sweep,
            "onchip_cohort_pool_series_per_s": onchip_pool_series_s,
            "onchip_series_per_s": round(onchip_series_s, 2),
            "onchip_marginal_series_per_s":
                round(onchip_marginal_series_s, 1),
            "rigid_reg_40step_ms": round(reg_ms, 1),
            "rigid_reg_marginal_ms_per_step": round(reg_step_ms, 3),
            "demons_marginal_ms_per_iter": round(demons_iter_ms, 2),
            "raster_device_ms": round(raster_ms["device"], 1),
            "raster_cv2_ms": round(raster_ms["cv2"], 1),
            "raster_device_onchip_ms": round(raster_onchip_ms, 1),
            "raster_batch_onchip_ms": round(raster_batch_ms, 1),
            "raster_batch_per_roi_ms": round(raster_batch_per_roi_ms, 2),
            "raster_pooled_per_roi_ms": round(raster_pooled_per_roi_ms,
                                              2),
            "raster_cache_hit_ms": round(raster_cache_hit_ms, 3),
            "resample_filter_batch_ms": round(resample_ms, 1),
            "marching_cubes_ms": round(mc_ms, 1),
            "mc_path": mc_path,
            "voxelize_ms": round(voxelize_ms, 1),
            "voxelize_host_ms": round(vox_host_ms, 1),
            "voxelize_device_onchip_ms": round(vox_dev_ms, 1),
            "voxelize_batch_onchip_ms": round(vox_batch_ms, 1),
            "voxelize_batch_per_mesh_ms": round(vox_batch_per_mesh_ms,
                                                2),
            "voxelize_compute_marginal_per_mesh_ms": round(
                vox_compute_marginal_per_mesh_ms, 2),
            "affine_reslice_marginal_ms": round(affine_ms, 3),
            "affine_reslice_mpts_per_s": round(affine_mpts, 1),
            "oblique_reslice_marginal_ms": round(oblique_ms, 3),
            "oblique_reslice_mpts_per_s": round(oblique_mpts, 1),
            "gamma_3pct3mm_64x100x100_ms": round(gamma_full_ms, 1),
            "gamma_search_marginal_ms": round(gamma_marg_ms, 1),
            "gamma_search_offsets": gamma_noff,
        },
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
    }))


if __name__ == "__main__":
    main()
