"""3-D gamma-index dose comparison (device kernel).

BEYOND-PARITY: the reference has no dose-comparison tooling at all —
its Dose object ends at DVH statistics (reference structure/dose.py:
774-816). Gamma analysis (Low et al. 1998) is the standard QA metric
for comparing a recomputed / accumulated / measured dose against a
planned one: every voxel gets

    gamma(r) = min over r' of sqrt( |r' - r|^2 / dta^2
                                  + (D_eval(r') - D_ref(r))^2 / dD^2 )

and a plan "passes" where gamma <= 1.

Device formulation: the eval dose is resampled ONCE onto a fine
sub-voxel grid aligned with the reference grid (sub-voxel search is
what makes gamma exact-ish; AAPM TG-218 recommends an interpolation
step <= dta/3). Every fine-grid search offset o then decomposes as
o = q * s + p: a sub-voxel *phase* p in [0, s) and an integer
ref-grid shift q. The s_z*s_y*s_x phase grids are carved out of the
fine volume once with static strided slices; the minimisation is a
single `lax.scan` over the offset list whose body is one
`dynamic_slice` (the integer shift) + FMA + min — pure HBM streaming,
no gathers, one compiled body regardless of how many thousand offsets
the criteria imply. The offset list is a runtime argument, so dose
criteria (dose_pct / local / threshold) never recompile; dta, cap and
subdiv feed the static (s, r) layout and DO compile a new program
when they change. The list is pruned
host-side to the sphere |d| <= cap * dta (offsets further out cannot
produce a gamma below `cap`), so the reported map is exact for all
values <= cap and clamped above it.
"""

from __future__ import annotations

from functools import lru_cache

import numpy as np

import jax
import jax.numpy as jnp
from jax import lax

__all__ = ["gamma_index", "fine_grid_layout"]

_OUTSIDE = np.float32(3.0e30)  # eval-fine background: never matches


def fine_grid_layout(spacing, dta_mm, subdiv=None, cap=2.0):
    """Host-side search-layout decision.

    Returns (s, r, offsets, dist2) where ``s``/(z,y,x) are the per-axis
    sub-division factors (fine spacing <= dta/3, TG-218), ``r`` the
    per-axis search radii in fine steps (covering cap*dta), ``offsets``
    an (M, 3) int array of fine-step offsets inside the pruning sphere
    and ``dist2`` their squared physical distances in mm^2.
    """
    sp = np.asarray(spacing, np.float64)  # [sx, sy, sz]
    sp_zyx = sp[::-1]
    if subdiv is None:
        target = dta_mm / 3.0
        s = np.maximum(1, np.ceil(sp_zyx / target - 1e-9)).astype(int)
    else:
        s = np.full(3, int(subdiv), int)
    fine_sp = sp_zyx / s
    reach = cap * dta_mm
    r = np.ceil(reach / fine_sp - 1e-9).astype(int)

    oz, oy, ox = np.mgrid[-r[0]:r[0] + 1, -r[1]:r[1] + 1, -r[2]:r[2] + 1]
    d2 = ((oz * fine_sp[0]) ** 2 + (oy * fine_sp[1]) ** 2
          + (ox * fine_sp[2]) ** 2)
    keep = d2 <= reach * reach + 1e-9
    offsets = np.stack([oz[keep], oy[keep], ox[keep]], axis=1)
    dist2 = d2[keep]
    order = np.argsort(dist2, kind="stable")  # center first
    return tuple(int(v) for v in s), tuple(int(v) for v in r), \
        offsets[order], dist2[order]


def _decompose_offsets(offsets, s, r):
    """Host: fine-step offsets (M, 3) -> (phase_index, qz, qy, qx)
    int32 rows. Along each axis the fine index of ref voxel k at
    offset o is k*s + (r + o) = (k + q)*s + p with p = (r+o) mod s."""
    s = np.asarray(s, np.int64)
    r = np.asarray(r, np.int64)
    shifted = offsets + r[None, :]
    p = shifted % s[None, :]
    q = shifted // s[None, :]
    pidx = (p[:, 0] * s[1] + p[:, 1]) * s[2] + p[:, 2]
    return np.concatenate([pidx[:, None], q], axis=1).astype(np.int32)


@lru_cache(maxsize=32)
def _gamma_fn(ref_shape, s, r, chunk):
    """Build the jitted gamma kernel for a static grid layout.

    The offset list rides in as runtime data: a scan over
    (phase_index, qz, qy, qx, dist2) rows whose body dynamic-slices
    the pre-carved phase grids — one compiled program per
    (shape, subdiv, radius) regardless of criteria.
    """
    Z, Y, X = ref_shape
    sz, sy, sx = s
    rz, ry, rx = r
    # integer-shift head-room per axis: q ranges over [0, 2r // s]
    qz_max, qy_max, qx_max = 2 * rz // sz, 2 * ry // sy, 2 * rx // sx

    def carve_phases(fine):
        """(s^3, Z + qmax, Y + qmax, X + qmax) phase grids as one
        pad + reshape + transpose (no per-phase slicing — subdiv can be
        large without trace blow-up); the high-end pad carries the
        outside sentinel where the strided comb runs past the fine
        volume (never addressed by in-sphere offsets)."""
        Lz = (Z + qz_max) * sz
        Ly = (Y + qy_max) * sy
        Lx = (X + qx_max) * sx
        f = jnp.pad(fine, ((0, Lz - fine.shape[0]),
                           (0, Ly - fine.shape[1]),
                           (0, Lx - fine.shape[2])),
                    constant_values=_OUTSIDE)
        f = f.reshape(Z + qz_max, sz, Y + qy_max, sy, X + qx_max, sx)
        f = f.transpose(1, 3, 5, 0, 2, 4)
        return f.reshape(sz * sy * sx, Z + qz_max, Y + qy_max,
                         X + qx_max)

    def run(ref, fine, dd2, offsets, dist2, dta2):
        ref = ref.astype(jnp.float32)
        dd2 = jnp.asarray(dd2, jnp.float32)
        phases = carve_phases(fine.astype(jnp.float32))

        def body(gam2, row):
            off, d2 = row
            g = lax.dynamic_index_in_dim(phases, off[0], 0,
                                         keepdims=False)
            ev = lax.dynamic_slice(g, (off[1], off[2], off[3]),
                                   (Z, Y, X))
            diff = ev - ref
            g2 = d2 / dta2 + diff * diff / dd2
            return jnp.minimum(gam2, g2), None

        gam2 = jnp.full(ref.shape, np.float32(1e30))
        gam2, _ = lax.scan(body, gam2, (offsets, dist2))
        return jnp.sqrt(gam2)

    if chunk is None:
        return jax.jit(run)

    def run_chunked(ref, fine, dd2, offsets, dist2, dta2):
        # z-chunked: each output chunk needs fine rows
        # [z0*sz, z0*sz + (cz-1)*sz + 2rz] — bounds the peak working
        # set (phase grids) on large dose grids
        parts = []
        per_vox_dd = np.ndim(dd2) == 3
        for z0 in range(0, Z, chunk):
            cz = min(chunk, Z - z0)
            fsub = fine[z0 * sz:z0 * sz + (cz - 1) * sz + 2 * rz + 1]
            rsub = ref[z0:z0 + cz]
            dsub = dd2[z0:z0 + cz] if per_vox_dd else dd2
            sub = _gamma_fn((cz, Y, X), s, r, None)
            parts.append(sub(rsub, fsub, dsub, offsets, dist2, dta2))
        return jnp.concatenate(parts, axis=0)

    return run_chunked


def gamma_index(ref_dose, eval_fine, spacing, dose_pct=3.0, dta_mm=3.0,
                local=False, norm_dose=None, threshold_pct=10.0,
                subdiv=None, cap=2.0, chunk=None, layout=None):
    """Gamma map of ``eval`` vs ``ref_dose`` on the reference grid.

    Parameters
    ----------
    ref_dose : (Z, Y, X) reference dose on its own grid.
    eval_fine : the evaluated dose already resampled onto the padded
        fine grid from :func:`fine_grid_layout` /
        :func:`fine_grid_shape` (use ``Dose.compute_gamma`` for the
        end-to-end path, or :func:`upsample_to_fine` when both doses
        share a grid). Out-of-volume samples must carry the
        ``_OUTSIDE`` background so they can never beat a real match.
    spacing : [sx, sy, sz] mm of the reference grid.
    dose_pct : dose-difference criterion in percent.
    dta_mm : distance-to-agreement criterion in mm.
    local : False -> global gamma (dD = pct% of ``norm_dose``, default
        max(ref)); True -> local (dD = pct% of |ref| per voxel).
    threshold_pct : voxels with ref < pct% of norm are excluded from
        the pass-rate (reported, still present in the map).
    cap : search-sphere radius in gamma units; values above ``cap``
        are exact only in their being > cap (clamped search).
    chunk : optional z-chunk size bounding the working set.

    Returns dict: gamma (Z,Y,X) float32, pass_rate, mean/max gamma
    over the analysed region, analysed voxel count, and the mask.
    """
    if cap < 1.0:
        # gamma values above cap are clamped, and pass_rate counts
        # g <= 1: a sub-1 cap would report true failures as passes
        raise ValueError(f"gamma_index: cap must be >= 1, got {cap}")
    ref = np.asarray(ref_dose, np.float32)
    s, r, offsets, dist2 = (layout if layout is not None else
                            fine_grid_layout(spacing, dta_mm, subdiv,
                                             cap))
    expect = tuple((n - 1) * si + 2 * ri + 1
                   for n, si, ri in zip(ref.shape, s, r))
    if tuple(eval_fine.shape) != expect:
        raise ValueError(
            f"gamma_index: eval_fine shape {tuple(eval_fine.shape)} != "
            f"expected fine-grid shape {expect} for s={s} r={r}")

    if norm_dose is None:
        norm_dose = float(ref.max())
    if norm_dose <= 0:
        raise ValueError("gamma_index: non-positive normalisation dose")
    if local:
        dd = (dose_pct / 100.0) * np.maximum(np.abs(ref),
                                             1e-6 * norm_dose)
        dd2 = (dd * dd).astype(np.float32)
    else:
        dd = dose_pct / 100.0 * norm_dose
        dd2 = np.float32(dd * dd)

    fn = _gamma_fn(tuple(ref.shape), s, r,
                   None if chunk is None else int(chunk))
    rows = _decompose_offsets(offsets, s, r)
    gamma = np.asarray(fn(jnp.asarray(ref), jnp.asarray(eval_fine), dd2,
                          jnp.asarray(rows),
                          jnp.asarray(dist2, jnp.float32),
                          jnp.float32(dta_mm * dta_mm)))
    gamma = np.minimum(gamma, np.float32(cap))

    mask = ref >= (threshold_pct / 100.0) * norm_dose
    n = int(mask.sum())
    if n:
        g = gamma[mask]
        pass_rate = float((g <= 1.0).mean() * 100.0)
        gmean, gmax = float(g.mean()), float(g.max())
    else:
        pass_rate, gmean, gmax = 100.0, 0.0, 0.0
    return {"gamma": gamma, "pass_rate": pass_rate, "mean": gmean,
            "max": gmax, "analysed_voxels": n, "mask": mask,
            "norm_dose": float(norm_dose), "cap": float(cap),
            "subdiv": s, "search_offsets": int(len(dist2))}


def fine_grid_shape(ref_shape, s, r):
    """Padded fine-grid dims for :func:`gamma_index`'s eval input."""
    return tuple((n - 1) * si + 2 * ri + 1
                 for n, si, ri in zip(ref_shape, s, r))


def fine_to_ref_pixel_matrix(s, r):
    """4x4 mapping fine-grid pixel (x, y, z, 1) -> ref-grid pixel.

    Fine pixel f along an axis sits at ref-pixel coordinate
    (f - r) / s; compose with the ref->eval pixel matrix to resample
    the eval dose straight onto the fine grid in ONE interpolation.
    """
    sz, sy, sx = s
    rz, ry, rx = r
    A = np.eye(4, dtype=np.float64)
    A[0, 0], A[1, 1], A[2, 2] = 1.0 / sx, 1.0 / sy, 1.0 / sz
    A[0, 3], A[1, 3], A[2, 3] = -rx / sx, -ry / sy, -rz / sz
    return A


def upsample_to_fine(eval_on_ref_grid, s, r):
    """Trilinearly upsample an eval dose that already shares the
    reference grid onto the padded fine grid. Endpoint-aligned
    (fine index f sits at ref pixel f/s exactly — jax.image.resize's
    half-pixel-center convention would shift the lattice), as three
    matrix contractions; the pad ring holds the outside sentinel."""
    from .resample import _interp_matrix, _separable_apply

    vol = jnp.asarray(eval_on_ref_grid, jnp.float32)
    sz, sy, sx = s
    rz, ry, rx = r
    if (sz, sy, sx) != (1, 1, 1):
        mz = jnp.asarray(_interp_matrix((vol.shape[0] - 1) * sz + 1,
                                        vol.shape[0], 1.0 / sz))
        my = jnp.asarray(_interp_matrix((vol.shape[1] - 1) * sy + 1,
                                        vol.shape[1], 1.0 / sy))
        mx = jnp.asarray(_interp_matrix((vol.shape[2] - 1) * sx + 1,
                                        vol.shape[2], 1.0 / sx))
        vol = _separable_apply(vol, mz, my, mx)
    return jnp.pad(vol, ((rz, rz), (ry, ry), (rx, rx)),
                   constant_values=_OUTSIDE)
