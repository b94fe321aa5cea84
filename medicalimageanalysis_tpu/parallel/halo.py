"""Spatially-sharded stencils with halo exchange.

SURVEY.md §5's sequence-parallel analogue: very large single volumes
shard their z-axis over the 'space' mesh axis; stencil kernels
(Gaussian here, the demons smoothing pattern) exchange a halo of
boundary slices with ring neighbors via lax.ppermute so each shard
convolves locally — only the halo rows cross between devices.
"""

from __future__ import annotations

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import NamedSharding, PartitionSpec as P

__all__ = ["gaussian_z_sharded", "warp_z_sharded", "demons_z_sharded",
           "demons_batch_z_sharded"]


def _gauss_taps(sigma_vox):
    """Shared tap formula: delegating to ops.filters.gauss_taps is
    what guarantees the sharded z-pass matches the dense Toeplitz
    matrix bit-for-bit (the parity the halo demons loop relies on)."""
    from ..ops.filters import gauss_taps
    return gauss_taps(sigma_vox, dtype=np.float32)


def gaussian_z_sharded(volume, sigma_vox, mesh, axis_name="space"):
    """Gaussian blur along z of a z-sharded (Z, Y, X) volume.

    The volume is placed with z split over `axis_name`; each shard
    ppermutes its top/bottom `radius` slices to the neighboring shards,
    then convolves its halo-extended slab locally. Global edges use
    edge replication (matches ops.filters.gaussian_filter's 'nearest').
    """
    taps, radius = _gauss_taps(float(sigma_vox))
    n_shards = mesh.shape[axis_name]
    Z = volume.shape[0]
    if Z % n_shards != 0:
        raise ValueError(f"z={Z} not divisible by {n_shards} shards")
    if radius > Z // n_shards:
        # the single-hop ring exchange can only serve one shard of
        # halo; without this guard the failure is an opaque broadcast
        # error deep inside shard_map tracing (review finding)
        raise ValueError(
            f"gaussian_z_sharded: smoothing radius {radius} exceeds "
            f"the {Z // n_shards}-slice shard depth; reduce sigma or "
            "use fewer z-shards")

    taps_j = jnp.asarray(taps)

    def local_fn(block):
        # block: (Z/n, Y, X) local shard, halo-extended by `radius`
        slab = _exchange_z(block, radius, n_shards, axis_name, 0)
        out = jnp.zeros_like(block)
        for t in range(2 * radius + 1):
            out = out + taps_j[t] * lax.dynamic_slice_in_dim(
                slab, t, block.shape[0], axis=0)
        return out

    sharding = NamedSharding(mesh, P(axis_name, None, None))
    # host array straight to its shards (jnp.asarray would first stage
    # the whole volume on one device)
    vol = jax.device_put(np.asarray(volume, np.float32), sharding)
    fn = jax.shard_map(local_fn, mesh=mesh,
                       in_specs=P(axis_name, None, None),
                       out_specs=P(axis_name, None, None))
    return jax.jit(fn)(vol)


def _exchange_z(block, h, n_shards, axis_name, z_axis):
    """Halo-extend a shard's block by h rows along `z_axis` via ring
    ppermute, edge-replicating at the global volume boundaries (the
    replicated rows reproduce the warp's edge-clamped taps and
    the Gaussian matrix's edge-replicate rows exactly)."""
    idx = lax.axis_index(axis_name)

    def take(b, lo, hi):
        sl = [slice(None)] * b.ndim
        sl[z_axis] = slice(lo, hi)
        return b[tuple(sl)]

    top = take(block, 0, h)
    bot = take(block, block.shape[z_axis] - h, block.shape[z_axis])
    from_below = lax.ppermute(
        bot, axis_name, [(i, (i + 1) % n_shards) for i in range(n_shards)])
    from_above = lax.ppermute(
        top, axis_name, [(i, (i - 1) % n_shards) for i in range(n_shards)])
    edge_low = jnp.repeat(take(block, 0, 1), h, axis=z_axis)
    edge_high = jnp.repeat(
        take(block, block.shape[z_axis] - 1, block.shape[z_axis]), h,
        axis=z_axis)
    below = jnp.where(idx == 0, edge_low, from_below)
    above = jnp.where(idx == n_shards - 1, edge_high, from_above)
    return jnp.concatenate([below, block, above], axis=z_axis)


def _halo_depth(halo, Zl):
    """Effective halo depth for a Zl-row shard. The ring exchange is
    single-hop, so the halo is bounded by the local shard depth; below
    3 rows the z-displacement cap (H - 2) cannot serve any motion."""
    H = min(int(halo), Zl)
    if H < 3:
        raise ValueError(
            f"effective halo {H} (min(halo={halo}, Z/shards={Zl})) is "
            "too shallow for any z-motion; use fewer shards or a "
            "deeper volume")
    return H


def _put_sharded(mesh, pairs):
    """Place host numpy arrays onto the mesh per [(array, spec), ...]
    WITHOUT staging any of them whole on one device (jnp.asarray here
    would — exactly the OOM the z-sharded entry points exist to
    avoid). Multi-host meshes build each global jax.Array
    shard-by-shard (device_put cannot target non-addressable devices).
    Returns (placed_arrays, multiproc)."""
    multiproc = any(d.process_index != jax.process_index()
                    for d in mesh.devices.flat)
    placed = []
    for arr, spec in pairs:
        sh = NamedSharding(mesh, spec)
        if multiproc:
            placed.append(jax.make_array_from_callback(
                arr.shape, sh, lambda idx, a=arr: a[idx]))
        else:
            placed.append(jax.device_put(arr, sh))
    return placed, multiproc


def _replicate(mesh, arr):
    """Replicate a sharded result so every process can pull it to
    host (np.asarray on an array spanning non-addressable devices
    raises)."""
    return jax.jit(jnp.asarray,
                   out_shardings=NamedSharding(mesh, P()))(arr)


def warp_z_sharded(volume, dvf_mm, mesh, spacing_xyz=(1.0, 1.0, 1.0),
                   background=0.0, halo=16, axis_name="space"):
    """Warp ONE large z-sharded volume by a DVF: the SPMD twin of
    :func:`ops.registration.dvf.warp_volume` (out(x) = volume(x+d(x)),
    d in mm, sampling convention) — the natural consumer of
    :func:`demons_z_sharded`'s field when the pair never fit one chip.

    SPMD structure: each shard halo-extends its moving slab by `halo`
    z-rows (ONE ring ppermute), then runs the displacement warp
    locally. x/y displacements are unlimited
    (rows are shard-local); z displacements are served from the halo,
    so |dz| is bounded by ``halo - 2`` rows. Points that need more
    reach than the halo provides take `background` and are COUNTED —
    a nonzero count warns to re-run with a larger `halo` (same
    diagnostic contract as demons_z_sharded), so every returned voxel
    is either exact or explicitly backgrounded, never silently wrong.

    volume: (Z, Y, X), dvf_mm: (Z, Y, X, 3) mm [x, y, z], Z divisible
    by the shard count. Returns the warped (Z, Y, X) volume (sharded
    jax.Array on the mesh; np.asarray pulls it to host).
    """
    from ..ops.warp import warp_disp

    n_shards = mesh.shape[axis_name]
    # stay HOST-side until the sharded placement (see demons_z_sharded)
    volume = np.asarray(volume, np.float32)
    dvf = np.asarray(dvf_mm, np.float32)
    Z, Y, X = volume.shape
    if dvf.shape != (Z, Y, X, 3):
        raise ValueError(f"dvf shape {dvf.shape} != {(Z, Y, X, 3)}")
    if Z % n_shards != 0:
        raise ValueError(f"z={Z} not divisible by {n_shards} shards")
    Zl = Z // n_shards
    H = _halo_depth(halo, Zl)
    sp = np.asarray(spacing_xyz, np.float32)
    bg = jnp.float32(background)

    def local_fn(vol_loc, disp_loc):
        # vol_loc (1, Zl, Y, X); disp_loc (3, Zl, Y, X) voxel [x, y, z]
        slab = _exchange_z(vol_loc, H, n_shards, axis_name, 1)
        idx = lax.axis_index(axis_name)
        z_base = (idx * Zl).astype(jnp.float32)
        zz = jnp.arange(Zl, dtype=jnp.float32)[:, None, None]
        cap = jnp.float32(H - 2)
        dz = disp_loc[2]
        gz = z_base + zz + dz
        # the single-device warp backgrounds samples outside
        # [0, Z-1]; the halo slab's edge-replicated global-boundary
        # rows would edge-interp instead, so mask on GLOBAL z here
        z_in = (gz >= 0.0) & (gz <= jnp.float32(Z - 1))
        over_cap = jnp.abs(dz) > cap
        disp = jnp.stack([disp_loc[0], disp_loc[1],
                          jnp.clip(dz, -cap, cap) + jnp.float32(H)])
        w = warp_disp(slab, disp, background)
        # a cap-clamped in-volume sample is wrong either way:
        # background + counted (exact-or-backgrounded contract)
        out = jnp.where(over_cap | ~z_in, bg, w[0])
        halo_ovf = jnp.sum((over_cap & z_in).astype(jnp.float32))
        return out, lax.psum(halo_ovf, axis_name)

    fn = jax.shard_map(
        local_fn, mesh=mesh,
        in_specs=(P(None, axis_name, None, None),
                  P(None, axis_name, None, None)),
        out_specs=(P(axis_name, None, None), P()))
    run = jax.jit(lambda v, d: fn(v[None], d))

    disp_host = np.moveaxis(dvf / sp, -1, 0)  # (3, Z, Y, X) voxels
    (v, d), multiproc = _put_sharded(mesh, [
        (volume, P(axis_name, None, None)),
        (disp_host, P(None, axis_name, None, None))])
    out, halo_ovf = run(v, d)
    if float(jax.device_get(halo_ovf).ravel()[0]) > 0:
        import warnings
        warnings.warn(
            "warp_z_sharded: z-displacements exceeded the halo reach "
            f"(cap {H - 2} rows); affected voxels took the background. "
            "Increase halo or use fewer z-shards.", RuntimeWarning)
    if multiproc:
        out = _replicate(mesh, out)
    return out


def _make_pair_loop(n_shards, axis_name, Z, Zl, Y, X, H, sp, taps_j,
                    my, mx, radius, symmetric, smooth, iterations, step,
                    intensity_threshold, forces="ssd", lncc_radius=3):
    """Per-pair z-sharded demons loop (closure over the static config);
    shared by :func:`demons_z_sharded` (one pair) and
    :func:`demons_batch_z_sharded` (lax.map over local pairs).

    forces='lncc' swaps in the ANTs-CC update: the windowed moments'
    y/x passes are shard-local banded-matrix einsums and the z pass is
    a sliding-window sum over an ``lncc_radius``-row halo with
    GLOBAL-EDGE ZEROING (the dense path's clipped basis matrices
    truncate windows at the volume edge — edge replication here would
    silently diverge from the single-device field)."""
    from ..ops.warp import warp_disp

    def local_loop(f_loc, stack_loc, gf_loc):
        # f_loc (Zl,Y,X); stack_loc (B,Zl,Y,X); gf_loc (3,Zl,Y,X)
        slab = _exchange_z(stack_loc, H, n_shards, axis_name, 1)
        idx = lax.axis_index(axis_name)
        z_base = (idx * Zl).astype(jnp.float32)
        zz_loc = jnp.arange(Zl, dtype=jnp.float32)[:, None, None]
        K = jnp.mean(sp) ** 2
        spc = sp[:, None, None, None]
        cap = jnp.float32(H - 2)

        def gauss_smooth(u):
            # y/x: shard-local contractions; z: taps over a
            # radius-row halo (same taps + edge replication as the
            # dense _gauss_kernel_matrix -> identical result)
            hi = lax.Precision.HIGHEST
            u = jnp.einsum("kj,czjx->czkx", my, u, precision=hi,
                           preferred_element_type=jnp.float32)
            u = jnp.einsum("lj,czyj->czyl", mx, u, precision=hi,
                           preferred_element_type=jnp.float32)
            uslab = _exchange_z(u, radius, n_shards, axis_name, 1)
            acc = jnp.zeros_like(u)
            for t in range(2 * radius + 1):
                acc = acc + taps_j[t] * lax.dynamic_slice_in_dim(
                    uslab, t, Zl, axis=1)
            return acc

        if forces == "lncc":
            from ..ops.registration.demons import (_box_matrix,
                                                   _lncc_force)
            R = int(lncc_radius)
            lyb = jnp.asarray(_box_matrix(Y, R))
            lxb = jnp.asarray(_box_matrix(X, R))
            hi = lax.Precision.HIGHEST
            # slab-row global validity for the R-halo (loop-invariant)
            zvalid = ((z_base - R
                       + jnp.arange(Zl + 2 * R, dtype=jnp.float32))
                      >= 0)[:, None, None] \
                & ((z_base - R
                    + jnp.arange(Zl + 2 * R, dtype=jnp.float32))
                   <= jnp.float32(Z - 1))[:, None, None]

            def box_sum(v):
                vs = _exchange_z(v[None], R, n_shards, axis_name, 1)[0]
                vs = jnp.where(zvalid, vs, 0.0)
                acc = jnp.zeros_like(v)
                for t in range(2 * R + 1):
                    acc = acc + lax.dynamic_slice_in_dim(vs, t, Zl,
                                                         axis=0)
                acc = jnp.einsum("kj,zjx->zkx", lyb, acc, precision=hi,
                                 preferred_element_type=jnp.float32)
                return jnp.einsum("lj,zyj->zyl", lxb, acc, precision=hi,
                                  preferred_element_type=jnp.float32)

            cnt = box_sum(jnp.ones_like(f_loc))
            # global centering (LNCC shift-invariance; kills the f32
            # E[x^2]-E[x]^2 cancellation — see ops _demons_core)
            npts = jnp.float32(Z * Y * X)
            f_cent = f_loc - lax.psum(jnp.sum(f_loc), axis_name) / npts
            m_shift = lax.psum(jnp.sum(stack_loc[0]), axis_name) / npts
            mu_f = box_sum(f_cent) / cnt
            var_f = jnp.maximum(
                box_sum(f_cent * f_cent) / cnt - mu_f ** 2, 0.0)
            i_f = f_cent - mu_f
            vmean = lax.psum(jnp.sum(var_f), axis_name) / npts
            v_eps = 1e-5 * jnp.maximum(vmean, 1e-12)

        def body(_, u_vox):
            uz = jnp.clip(u_vox[2], -cap, cap)
            disp = jnp.stack([u_vox[0], u_vox[1], uz + jnp.float32(H)])
            w = warp_disp(slab, disp, 0.0)
            # global-z bounds: the halo slab edge-replicates past the
            # volume, but out-of-volume samples must take background 0
            # exactly like the single-device warp's inside test
            gz = z_base + zz_loc + uz
            z_in = (gz >= 0) & (gz <= jnp.float32(Z - 1))
            w = jnp.where(z_in[None], w, 0.0)
            warped = w[0]
            if forces == "lncc":
                w_cent = warped - m_shift
                mu_m = box_sum(w_cent) / cnt
                var_m = jnp.maximum(
                    box_sum(w_cent * w_cent) / cnt - mu_m ** 2, 0.0)
                cross = box_sum(f_cent * w_cent) / cnt - mu_f * mu_m
                upd_mm = _lncc_force(i_f, var_f, w_cent - mu_m, var_m,
                                     cross, w[1:4], v_eps)
                # fluid smoothing BEFORE the gradient-step
                # normalization (same rationale as the dense core)
                upd_mm = gauss_smooth(upd_mm)
                local_max2 = jnp.max(jnp.sum(upd_mm * upd_mm, axis=0))
                max_norm = jnp.sqrt(lax.pmax(local_max2, axis_name))
                upd_mm = upd_mm * (step / jnp.maximum(max_norm, 1e-12))
            else:
                diff = f_loc - warped
                g = 0.5 * (gf_loc + w[1:4]) if symmetric else gf_loc
                g2 = jnp.sum(g * g, axis=0)
                denom = g2 + (diff * diff) / K
                active = ((jnp.abs(diff) > intensity_threshold)
                          & (denom > 1e-9))
                upd_mm = jnp.where(
                    active[None],
                    (diff / jnp.maximum(denom, 1e-9))[None] * g, 0.0)
                if symmetric:
                    local_max2 = jnp.max(jnp.sum(upd_mm * upd_mm,
                                                 axis=0))
                    max_norm = jnp.sqrt(lax.pmax(local_max2, axis_name))
                    scale = jnp.minimum(
                        1.0, step / jnp.maximum(max_norm, 1e-9))
                    upd_mm = upd_mm * scale
            u_new = u_vox + upd_mm / spc
            if smooth:
                u_new = gauss_smooth(u_new)
            return u_new

        # derive u0 from a shard-local value: the loop carry must be
        # 'varying' over the space axis (shard_map typing), which a
        # bare jnp.zeros is not; XLA folds the 0*f term away
        u0 = jnp.zeros((3, Zl, Y, X), jnp.float32) + 0.0 * f_loc[None]
        return lax.fori_loop(0, int(iterations), body, u0)

    return local_loop


def demons_z_sharded(fixed, moving, mesh, spacing_xyz=(1.0, 1.0, 1.0),
                     method="fast", iterations=30, smooth=True, std=1,
                     step=2.0, intensity_threshold=0.001, halo=16,
                     axis_name="space", forces="ssd", lncc_radius=3):
    """Demons registration of ONE large volume z-sharded over the
    `axis_name` mesh axis (SPMD sequence-parallel analogue for volumes
    too large for a single chip's HBM, or to put all chips on one pair).

    SPMD structure:

    - the moving image + its gradient stack is halo-extended by `halo`
      z-rows ONCE (loop-invariant ring ppermute);
    - every iteration runs the displacement warp per shard on its
      local halo'd slab (sampling at local row + halo + u_z), pointwise
      force math locally, one `lax.pmax` scalar for the step
      normalization, and — only when smoothing — a radius-row halo
      ppermute for the z pass (y/x passes are shard-local matmuls);
    - per-shard z-displacement is clamped to ``halo - 2`` rows for
      sampling (document/raise `halo` for organ-scale motion; the x/y
      components are unlimited). Within that bound the semantics match
      the single-device :func:`demons_registration`; the fields agree
      to f32 tolerance (tests/test_parallel.py). Demons is iteratively
      bistable at the ``|diff| > threshold`` knife-edge, so a different
      summation order can move single voxels onto the other branch.

    fixed/moving: (Z, Y, X) with Z divisible by the shard count.
    Returns a (Z, Y, X, 3) mm DVF (host numpy).
    method: 'demons' (fixed-gradient Thirion) or 'fast' (symmetric).
    forces: 'ssd' | 'lncc' (ANTs-CC cross-modality forces; the z pass
    of the windowed moments rides an extra lncc_radius-row halo).
    """
    from ..ops.filters import _gauss_kernel_matrix

    if method not in ("demons", "fast"):
        raise ValueError("sharded demons supports 'demons' and 'fast'; "
                         "use demons_registration for diffeomorphic")
    if forces not in ("ssd", "lncc"):
        raise ValueError(f"demons_z_sharded: forces must be 'ssd' or "
                         f"'lncc', got {forces!r}")
    n_shards = mesh.shape[axis_name]
    # stay HOST-side until the sharded placement: jnp.asarray here
    # would stage the whole volume on one local device — exactly the
    # OOM this function exists to avoid (review finding)
    fixed = np.asarray(fixed, np.float32)
    moving = np.asarray(moving, np.float32)
    Z, Y, X = fixed.shape
    if Z % n_shards != 0:
        raise ValueError(f"z={Z} not divisible by {n_shards} shards")
    Zl = Z // n_shards
    H = _halo_depth(halo, Zl)
    sp = jnp.asarray(spacing_xyz, jnp.float32)

    taps, radius = _gauss_taps(max(float(std), 1e-3))
    if smooth and radius > Zl:
        raise ValueError(
            f"smoothing radius {radius} exceeds the {Zl}-row shard "
            "depth; lower std or use fewer shards")
    taps_j = jnp.asarray(taps)
    my = jnp.asarray(_gauss_kernel_matrix(Y, max(float(std), 1e-3)))
    mx = jnp.asarray(_gauss_kernel_matrix(X, max(float(std), 1e-3)))
    symmetric = method == "fast"
    if forces == "lncc" and int(lncc_radius) > Zl:
        raise ValueError(
            f"lncc_radius {lncc_radius} exceeds the {Zl}-row shard "
            "depth; use fewer z-shards")

    local_loop = _make_pair_loop(
        n_shards, axis_name, Z, Zl, Y, X, H, sp, taps_j, my, mx,
        radius, symmetric, smooth, iterations, step,
        intensity_threshold, forces=forces,
        lncc_radius=int(lncc_radius))

    @jax.jit
    def run(f, m):
        # loop-invariant prep on the GLOBAL arrays: XLA partitions the
        # gradient stencils itself (1-row halo collectives)
        gz, gy, gx = jnp.gradient(f)
        grad_f = jnp.stack([gx / sp[0], gy / sp[1], gz / sp[2]])
        if symmetric or forces == "lncc":
            mz_, my_, mx_ = jnp.gradient(m)
            stack = jnp.stack([m, mx_ / sp[0], my_ / sp[1], mz_ / sp[2]])
        else:
            stack = m[None]
        fn = jax.shard_map(
            local_loop, mesh=mesh,
            in_specs=(P(axis_name, None, None),
                      P(None, axis_name, None, None),
                      P(None, axis_name, None, None)),
            out_specs=P(None, axis_name, None, None))
        return fn(f, stack, grad_f)

    spec = P(axis_name, None, None)
    (f, m), multiproc = _put_sharded(mesh, [(fixed, spec), (moving, spec)])
    u = run(f, m)
    if multiproc:
        # replicate so every process can read the full field
        u = _replicate(mesh, u)
    return np.moveaxis(np.asarray(u), 0, -1) * np.asarray(spacing_xyz)


def demons_batch_z_sharded(fixed_batch, moving_batch, mesh,
                           spacing_xyz=(1.0, 1.0, 1.0), method="fast",
                           iterations=30, smooth=True, std=1, step=2.0,
                           intensity_threshold=0.001, halo=16,
                           data_axis="data", space_axis="space",
                           forces="ssd", lncc_radius=3):
    """Demons over B pairs x z-shards on the FULL ('data', 'space')
    mesh at once (VERDICT r2 next #6: ``demons_batch`` replicated
    'space', leaving half the mesh idle for cohorts of huge volumes).

    The pair axis splits over `data_axis`; each pair's z-axis splits
    over `space_axis` with the same halo-exchange iteration loop as
    :func:`demons_z_sharded` (shared `_make_pair_loop`). Local pairs
    run under ``lax.map`` — every 'space' peer maps the same local
    pair count, so the per-pair ring ppermutes/pmax line up across the
    axis (legal SPMD). Within the halo's z-displacement cap the
    per-pair fields match the single-device trajectories to f32
    tolerance (tests/test_parallel.py).

    fixed/moving: (B, Z, Y, X); B divisible by the 'data' size, Z by
    the 'space' size. Returns (B, Z, Y, X, 3) mm DVFs (host numpy).
    """
    from ..ops.filters import _gauss_kernel_matrix

    if method not in ("demons", "fast"):
        raise ValueError("sharded demons supports 'demons' and 'fast'")
    if forces not in ("ssd", "lncc"):
        raise ValueError(f"demons_batch_z_sharded: forces must be "
                         f"'ssd' or 'lncc', got {forces!r}")
    n_data = mesh.shape[data_axis]
    n_shards = mesh.shape[space_axis]
    fixed = np.asarray(fixed_batch, np.float32)
    moving = np.asarray(moving_batch, np.float32)
    B, Z, Y, X = fixed.shape
    if B % n_data != 0:
        raise ValueError(f"B={B} not divisible by {n_data} data shards")
    if Z % n_shards != 0:
        raise ValueError(f"z={Z} not divisible by {n_shards} shards")
    Zl = Z // n_shards
    H = _halo_depth(halo, Zl)
    sp = jnp.asarray(spacing_xyz, jnp.float32)
    taps, radius = _gauss_taps(max(float(std), 1e-3))
    if smooth and radius > Zl:
        raise ValueError(
            f"smoothing radius {radius} exceeds the {Zl}-row shard depth")
    taps_j = jnp.asarray(taps)
    my = jnp.asarray(_gauss_kernel_matrix(Y, max(float(std), 1e-3)))
    mx = jnp.asarray(_gauss_kernel_matrix(X, max(float(std), 1e-3)))
    symmetric = method == "fast"
    if forces == "lncc" and int(lncc_radius) > Zl:
        raise ValueError(
            f"lncc_radius {lncc_radius} exceeds the {Zl}-row shard "
            "depth; use fewer z-shards")

    pair_loop = _make_pair_loop(
        n_shards, space_axis, Z, Zl, Y, X, H, sp, taps_j, my, mx,
        radius, symmetric, smooth, iterations, step,
        intensity_threshold, forces=forces,
        lncc_radius=int(lncc_radius))

    def local_batch(f_loc, stack_loc, gf_loc):
        # f_loc (Bl, Zl, Y, X); stack (Bl, C, Zl, Y, X); gf (Bl, 3, ...)
        return lax.map(lambda args: pair_loop(*args),
                       (f_loc, stack_loc, gf_loc))

    @jax.jit
    def run(f, m):
        gz, gy, gx = jnp.gradient(f, axis=(1, 2, 3))
        grad_f = jnp.stack([gx / sp[0], gy / sp[1], gz / sp[2]], axis=1)
        if symmetric or forces == "lncc":
            mz_, my_, mx_ = jnp.gradient(m, axis=(1, 2, 3))
            stack = jnp.stack(
                [m, mx_ / sp[0], my_ / sp[1], mz_ / sp[2]], axis=1)
        else:
            stack = m[:, None]
        fn = jax.shard_map(
            local_batch, mesh=mesh,
            in_specs=(P(data_axis, space_axis, None, None),
                      P(data_axis, None, space_axis, None, None),
                      P(data_axis, None, space_axis, None, None)),
            out_specs=P(data_axis, None, space_axis, None, None))
        return fn(f, stack, grad_f)

    spec = P(data_axis, space_axis, None, None)
    (f, m), multiproc = _put_sharded(mesh, [(fixed, spec), (moving, spec)])
    u = run(f, m)
    if multiproc:
        u = _replicate(mesh, u)
    return np.moveaxis(np.asarray(u), 1, -1) * np.asarray(spacing_xyz)
