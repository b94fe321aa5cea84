"""Deformable registration object + Display.

Behavior-parity rebuild of reference structure/deformable.py:32-1001 on
the device kernels (ops/registration/{demons,bspline,dvf}). DVFs are
(Z, Y, X, 3) mm fields in the "point displacement" convention the
reference's consumers assume (update_rois adds d(p) to moving points;
create_image inverts to get the sampling field) — the reference's
``ratio`` parameter, ignored there (structure/deformable.py:766 comment),
is honored here so fractional-deformation display works.
"""

from __future__ import annotations

import copy
import json
import os

import numpy as np

from ..config import config
from ..data import Data
from ..dicom import generate_uid
from ..ops import geometry as geo
from ..ops.registration.dvf import invert_dvf, sample_dvf_at_points
from ..ops.resample import affine_resample, compose_pixel_matrix

__all__ = ["Display", "Deformable"]


def _lazy_jit(fn):
    """jax.jit on first call (keeps jax out of import time) with ONE
    cached jitted callable, so repeated calls hit the jit cache
    instead of retracing a per-call closure."""
    import functools

    box = {}

    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if "jit" not in box:
            import jax
            box["jit"] = jax.jit(fn)
        return box["jit"](*args, **kwargs)

    return wrapper


@_lazy_jit
def _jacobian_det(d, inv_spacing):
    """det(I + grad d) per voxel: central differences of the mm
    point-displacement field. Module-level so jax.jit caches across
    Deformable instances / repeated QA calls (inv_spacing = [1/sx,
    1/sy, 1/sz] as a traced argument, no retrace per spacing)."""
    import jax.numpy as jnp

    gz = jnp.gradient(d, axis=0) * inv_spacing[2]
    gy = jnp.gradient(d, axis=1) * inv_spacing[1]
    gx = jnp.gradient(d, axis=2) * inv_spacing[0]
    # J[i, j] = delta_ij + dd_i/dx_j, columns (x, y, z)
    a = 1.0 + gx[..., 0]
    b, c = gy[..., 0], gz[..., 0]
    p, q = gx[..., 1], gz[..., 1]
    e = 1.0 + gy[..., 1]
    g, h = gx[..., 2], gy[..., 2]
    i = 1.0 + gz[..., 2]
    return (a * (e * i - q * h) - b * (p * i - q * g)
            + c * (p * h - e * g))


class Display(object):
    """Deformation view state: list of arrays at fractional ratios +
    DVF component slices (reference structure/deformable.py:32-384)."""

    def __init__(self, deformable):
        self.deformable = deformable

        self.origin = None
        self.spacing = None
        self.array = []
        self.image = None
        self.matrix = np.identity(3)

        self.slice_location = [0, 0, 0]
        self.scroll_max = None
        self.offset = {"Axial": [0, 0], "Coronal": [0, 0],
                       "Sagittal": [0, 0]}
        self.misc = {}

        self.compute_scroll_max()

    def compute_array(self, slice_plane, portion=0):
        array_slice = None
        if slice_plane == "Axial":
            if 0 <= self.slice_location[0] < self.array[portion].shape[0]:
                array_slice = self.array[portion][
                    self.slice_location[0], :, :].astype(np.double)
        elif slice_plane == "Coronal":
            if 0 <= self.slice_location[1] < self.array[portion].shape[1]:
                array_slice = self.array[portion][
                    :, self.slice_location[1], :].astype(np.double)
        else:
            if 0 <= self.slice_location[2] < self.array[portion].shape[2]:
                array_slice = self.array[portion][
                    :, :, self.slice_location[2]].astype(np.double)
        return array_slice

    def compute_deformation(self, division=1):
        """Sample the field at fractional ratios -> progressive frames
        (reference structure/deformable.py:124-141)."""
        for ii in range(division):
            ratio = (ii + 1) / division
            out = self.deformable.create_image(ratio=ratio)
            self.array += [out["array"]]
            self.spacing = tuple(out["spacing"])
            self.origin = np.asarray(out["origin"])
        self.compute_offset()
        self.compute_scroll_max()

    def compute_grid(self, slice_plane="Axial", vector="x"):
        """DVF component cross-section
        (reference structure/deformable.py:143-173)."""
        dvf = self.deformable.dvf
        if slice_plane == "Axial":
            dvf_plane = dvf[self.slice_location[0], :, :, :]
        elif slice_plane == "Coronal":
            dvf_plane = dvf[:, self.slice_location[1], :, :]
        else:
            dvf_plane = dvf[:, :, self.slice_location[2], :]
        comp = {"x": 0, "y": 1}.get(vector, 2)
        return dvf_plane[:, :, comp].astype(np.float32)

    def compute_matrix_pixel_to_position(self):
        return geo.pixel_to_position_matrix(self.matrix, self.spacing,
                                            self.origin)

    def compute_matrix_position_to_pixel(self):
        return geo.position_to_pixel_matrix(self.matrix, self.spacing,
                                            self.origin)

    def compute_mesh_slice(self, roi_name=None, location=None,
                           slice_plane=None, return_pixel=False):
        """Deformed-ROI-mesh plane cut
        (reference structure/deformable.py:216-275)."""
        if self.deformable.rois.get(roi_name) is None:
            self.deformable.update_rois(roi_name=roi_name)
        mesh = self.deformable.rois.get(roi_name)
        if mesh is None:
            return []

        m3 = np.identity(3)
        if slice_plane == "Axial":
            normal = m3[:3, 2]
        elif slice_plane == "Coronal":
            normal = m3[:3, 1]
        else:
            normal = m3[:3, 0]

        loops = mesh.slice_plane(normal=normal, origin=location)
        if not return_pixel:
            from ..utils.mesh.trimesh import _SliceResult
            return _SliceResult(loops)
        if not loops:
            return []
        pixels = self.convert_position_to_pixel(position=loops)
        pixel_corrected = []
        for pixel in pixels:
            if slice_plane == "Axial":
                pixel_corrected.append(pixel[:, :2])
            elif slice_plane == "Coronal":
                pixel_corrected.append(
                    np.column_stack((pixel[:, 0], pixel[:, 2])))
            else:
                pixel_corrected.append(pixel[:, 1:])
        return pixel_corrected

    def compute_offset(self):
        if self.deformable.reference_name is not None:
            pos = Data.image[self.deformable.reference_name].origin
            self.offset["Axial"][0] = (self.origin[0] - pos[0]) \
                / self.spacing[0]
            self.offset["Axial"][1] = (self.origin[1] - pos[1]) \
                / self.spacing[1]
            self.offset["Coronal"][0] = (self.origin[0] - pos[0]) \
                / self.spacing[0]
            self.offset["Coronal"][1] = (self.origin[2] - pos[2]) \
                / self.spacing[2]
            self.offset["Sagittal"][0] = (self.origin[1] - pos[1]) \
                / self.spacing[1]
            self.offset["Sagittal"][1] = (self.origin[2] - pos[2]) \
                / self.spacing[2]

    def compute_slice_location(self, position=None):
        if position is None:
            src = Data.image[self.deformable.reference_name].display
            source_location = np.flip(src.slice_location)
            position = src.compute_index_positions(source_location)
        self.slice_location = np.flip(np.round(
            (position - self.origin) / self.spacing).astype(np.int32))

    def compute_slice_origin(self, slice_plane):
        slice_origin = None
        if slice_plane == "Axial" \
                and 0 <= self.slice_location[0] <= self.scroll_max[0]:
            location = np.asarray([0, 0, self.slice_location[0]])
            slice_origin = self.origin + location * self.spacing
        elif slice_plane == "Coronal" \
                and 0 <= self.slice_location[1] <= self.scroll_max[1]:
            location = np.asarray([0, self.slice_location[1], 0])
            slice_origin = self.origin + location * self.spacing
        elif slice_plane == "Sagittal" \
                and 0 <= self.slice_location[2] <= self.scroll_max[2]:
            location = np.asarray([self.slice_location[2], 0, 0])
            slice_origin = self.origin + location * self.spacing
        return slice_origin

    def compute_scroll_max(self):
        if len(self.array) == 0:
            if self.deformable.dimensions is not None:
                self.scroll_max = np.asarray(
                    self.deformable.dimensions) - 1
        else:
            self.scroll_max = [self.array[-1].shape[0] - 1,
                               self.array[-1].shape[1] - 1,
                               self.array[-1].shape[2] - 1]

    def convert_position_to_pixel(self, position=None):
        m = self.compute_matrix_position_to_pixel()
        return [geo.apply_homogeneous(np.asarray(p, dtype=np.float64), m)
                for p in position]

    def update_slice_location(self, scroll, slice_plane):
        if slice_plane == "Axial":
            self.slice_location[0] = scroll
        elif slice_plane == "Coronal":
            self.slice_location[1] = scroll
        else:
            self.slice_location[2] = scroll


class Deformable(object):
    """Non-rigid registration record: DVF + rigid pre-transform
    (reference structure/deformable.py:387-1001)."""

    def __init__(self, dvf=None, origin=None, spacing=None, dimensions=None,
                 roi_names=None, rigid_matrix=None, dvf_matrix=None,
                 registration_name=None, reference_name=None,
                 moving_name=None, reference_sops=None, moving_sops=None,
                 reference_meshes=None, moving_meshes=None):
        self.reference_name = reference_name
        self.reference_sops = reference_sops
        self.moving_name = moving_name
        self.moving_sops = moving_sops
        self.roi_names = roi_names
        self.rigid_rois = dict.fromkeys(Data.roi_list)
        self.rois = dict.fromkeys(Data.roi_list)
        self.reference_mesh = reference_meshes
        self.moving_mesh = moving_meshes
        self.local_uid = generate_uid()

        self.modality = None
        if dvf_matrix is not None \
                and not np.allclose(dvf_matrix, np.identity(3), atol=1e-3):
            self.dvf, self.spacing, self.origin, self.dimensions = \
                self.correct_dvf_direction(dvf, spacing, origin, dvf_matrix)
        else:
            self.dvf = dvf
            self.origin = origin
            self.spacing = spacing
            self.dimensions = dimensions

        self.rigid_matrix = np.identity(4) if rigid_matrix is None \
            else rigid_matrix

        self.deformable_name = self.add_deformable(registration_name)

        self.display = Display(self)
        if self.dvf is not None:
            self.update_rois()

    def add_deformable(self, deformable_name):
        """'DVF_{ref}_{mov}[_N]' naming with collision suffixing
        (reference structure/deformable.py:479-511)."""
        if deformable_name is None:
            if self.reference_name is None and self.moving_name is None:
                deformable_name = "DVF_Unknown"
            else:
                deformable_name = ("DVF_" + str(self.reference_name) + "_"
                                   + str(self.moving_name))
            if deformable_name in Data.deformable_list:
                n = 1
                while f"{deformable_name}_{n}" in Data.deformable_list:
                    n += 1
                deformable_name = f"{deformable_name}_{n}"

        Data.deformable[deformable_name] = self
        Data.deformable_list += [deformable_name]
        return deformable_name

    def compute_aspect(self, slice_plane):
        if slice_plane == "Axial":
            return np.round(self.spacing[0] / self.spacing[1], 2)
        if slice_plane == "Coronal":
            return np.round(self.spacing[0] / self.spacing[2], 2)
        return np.round(self.spacing[1] / self.spacing[2], 2)

    def compute_biomechanical(self, modality_gradient=True, sigma=2,
                              smooth=True, std=1, iterations=50,
                              intensity_threshold=0.001, step=2.0,
                              elastic_lambda=0.2, crop=5):
        """Linear-elastic ('biomechanical') deformable registration.

        The reference reserved this as an empty stub
        (structure/deformable.py:536-540); here it is implemented as
        symmetric-forces demons with a Navier-Cauchy grad(div u)
        relaxation step per iteration (weight ``elastic_lambda``),
        giving tissue-like near-incompressible fields."""
        backend = self._backend(modality_gradient, sigma)
        backend.resample()
        dvf_volume = backend.biomechanical(
            smooth=smooth, std=std, iterations=iterations,
            intensity_threshold=intensity_threshold, step=step,
            elastic_lambda=elastic_lambda, crop=crop)
        self._store_dvf(dvf_volume)

    def _backend(self, modality_gradient, sigma):
        """Common setup: ref/mov volumes, cross-modality correction,
        ROI mask union + blur (reference structure/deformable.py:569-613;
        the reference's mask-union nesting bug — mov_mask only built on
        later iterations, :584-592 — is fixed here)."""
        from ..utils.deformable.jax_backend import DeformableJAX

        ref = Data.image[self.reference_name]
        mov = Data.image[self.moving_name]

        backend = DeformableJAX()
        backend.create_sitk_image(ref.array, ref.origin, ref.spacing,
                                  ref.matrix)
        backend.create_sitk_image(mov.array, mov.origin, mov.spacing,
                                  mov.matrix, reference=False)

        if ref.modality != mov.modality and modality_gradient:
            backend.cross_modality_correction()

        ref_mask = None
        mov_mask = None
        for roi_name in (self.roi_names or []):
            ref_roi = ref.rois.get(roi_name)
            mov_roi = mov.rois.get(roi_name)
            if ref_roi is None or mov_roi is None:
                continue
            if (ref_roi.mesh is not None
                    or ref_roi.contour_pixel is not None) \
                    and (mov_roi.mesh is not None
                         or mov_roi.contour_pixel is not None):
                rm = ref_roi.compute_mask()
                mm = mov_roi.compute_mask()
                ref_mask = rm if ref_mask is None else ref_mask + rm
                mov_mask = mm if mov_mask is None else mov_mask + mm

        if ref_mask is not None and mov_mask is not None:
            backend.create_sitk_image(ref_mask, ref.origin, ref.spacing,
                                      ref.matrix, mask=True)
            backend.create_sitk_image(mov_mask, mov.origin, mov.spacing,
                                      mov.matrix, reference=False,
                                      mask=True)
            if sigma is not None:
                backend.blur_mask(sigma=sigma)
        return backend

    def _store_dvf(self, dvf_volume):
        """Store in point-displacement convention: invert the sampling
        field the solvers return."""
        sampling = dvf_volume["array"]
        self.origin = np.asarray(dvf_volume["origin"])
        self.spacing = tuple(dvf_volume["spacing"])
        self.dvf = invert_dvf(sampling, dvf_volume["spacing"])
        self.dimensions = np.asarray(self.dvf.shape[:3])
        self.display.compute_scroll_max()

    def compute_bspline(self, modality_gradient=True, sigma=2,
                        control_spacing=None, mesh_size=None,
                        gradient=1e-5, iterations=100, crop=5):
        """B-spline FFD (reference structure/deformable.py:542-613)."""
        backend = self._backend(modality_gradient, sigma)
        # rigid pre-transform: resample moving through rigid_matrix
        ref = Data.image[self.reference_name]
        mov = Data.image[self.moving_name]
        A = compose_pixel_matrix(mov.matrix, mov.spacing, mov.origin,
                                 ref.matrix, ref.spacing, ref.origin,
                                 phys_transform=self.rigid_matrix)
        resampled = np.asarray(affine_resample(
            np.asarray(mov.array, np.float32), A, ref.array.shape,
            background=0.0))
        backend.create_sitk_image(resampled, ref.origin, ref.spacing,
                                  ref.matrix, reference=False)
        backend.resample()
        dvf_volume = backend.bspline(control_spacing=control_spacing,
                                     mesh_size=mesh_size,
                                     gradient=gradient,
                                     iterations=iterations, crop=crop)
        self._store_dvf(dvf_volume)

    def compute_demons(self, method=None, modality_gradient=True, sigma=2,
                       smooth=True, std=1, iterations=50,
                       intensity_threshold=0.001, step=2.0, crop=5,
                       pyramid=None, forces="ssd", lncc_radius=3):
        """Demons variants (reference structure/deformable.py:615-690).

        ``pyramid``: optional coarse-to-fine factors, e.g. (4, 2, 1) —
        beyond-parity multi-resolution schedule for large deformations
        (see ops.registration.demons.demons_registration).

        ``forces='lncc'`` — BEYOND-PARITY: ANTs-CC local normalized
        cross-correlation forces (window radius ``lncc_radius``),
        contrast-invariant for CT<->MR / cross-sequence pairs; pair it
        with ``modality_gradient=False`` since the CC metric replaces
        the gradient-magnitude preprocessing trick.

        ``method='syn'`` — BEYOND-PARITY: greedy SyN, inverse-
        consistent symmetric diffeomorphic registration (two half-maps
        meeting at the midpoint); with ``forces='lncc'`` this is the
        ANTs CC+SyN combination."""
        backend = self._backend(modality_gradient, sigma)
        backend.resample()
        if method in ("Demons", "demons"):
            dvf_volume = backend.demons(
                smooth=smooth, std=std, iterations=iterations,
                intensity_threshold=intensity_threshold, step=step,
                crop=crop, pyramid=pyramid, forces=forces,
                lncc_radius=lncc_radius)
        elif method in ("Diffeomorphic", "diffeomorphic"):
            dvf_volume = backend.diffeomorphic(
                smooth=smooth, std=std, iterations=iterations,
                intensity_threshold=intensity_threshold, step=step,
                crop=crop, pyramid=pyramid, forces=forces,
                lncc_radius=lncc_radius)
        elif method in ("SyN", "syn"):
            dvf_volume = backend.syn(
                smooth=smooth, std=std, iterations=iterations,
                intensity_threshold=intensity_threshold, step=step,
                crop=crop, pyramid=pyramid, forces=forces,
                lncc_radius=lncc_radius)
        else:
            dvf_volume = backend.fast_demons(
                smooth=smooth, std=std, iterations=iterations,
                intensity_threshold=intensity_threshold, step=step,
                crop=crop, pyramid=pyramid, forces=forces,
                lncc_radius=lncc_radius)
        self._store_dvf(dvf_volume)

    def compute_tps(self, poi_names=None, points_reference=None,
                    points_moving=None, regularization=0.0,
                    chunk=16384):
        """Landmark-driven deformable registration: 3-D thin-plate
        spline through matched POIs — BEYOND-PARITY (the reference
        has no landmark registration; its POIs are never used,
        structure/poi.py:18-28).

        Matches POI names shared by the reference and moving images
        (or takes explicit ``points_reference``/``points_moving``
        (N, 3) mm arrays). Moving points are pre-mapped through
        inv(rigid_matrix) — the same composition as update_pois — so
        the spline carries only the residual deformation; the dense
        field is evaluated over the reference grid as matmuls
        (ops/registration/tps.py) and stored in the package's
        point-displacement convention (p + d(p) lands in the
        reference frame). Exact at the landmarks when
        ``regularization`` is 0. Returns {name: residual mm} (or
        index keys for explicit points).
        """
        from ..ops.registration.tps import (tps_displacement, tps_fit,
                                            tps_displacement_grid)

        rigid_inv = np.linalg.inv(np.asarray(self.rigid_matrix,
                                             np.float64))
        if points_reference is not None or points_moving is not None:
            if points_reference is None or points_moving is None:
                raise ValueError(
                    "compute_tps: points_reference and points_moving "
                    "must be given together")
            t = np.asarray(points_reference, np.float64).reshape(-1, 3)
            m = np.asarray(points_moving, np.float64).reshape(-1, 3)
            if t.shape != m.shape:
                raise ValueError("compute_tps: point array shapes differ")
            names = [str(i) for i in range(t.shape[0])]
        else:
            ref_pois = Data.image[self.reference_name].pois
            mov_pois = Data.image[self.moving_name].pois
            names, t_list, m_list = [], [], []
            for name, poi in ref_pois.items():
                if poi_names is not None and name not in poi_names:
                    continue
                other = mov_pois.get(name)
                if poi.point_position is None or other is None \
                        or other.point_position is None:
                    continue
                names.append(name)
                t_list.append(np.asarray(poi.point_position,
                                         np.float64))
                m_list.append(np.asarray(other.point_position,
                                         np.float64))
            if not names:
                raise ValueError(
                    "compute_tps: no matched POIs with positions "
                    "between reference and moving images")
            t = np.stack(t_list)
            m = np.stack(m_list)

        p = (np.concatenate([m, np.ones((len(m), 1))], axis=1)
             @ rigid_inv.T)[:, :3]
        W, A = tps_fit(p, t - p, regularization=regularization)

        ref = Data.image[self.reference_name]
        # identity grid orientation, NOT ref.matrix: the package's DVF
        # samplers (sample_dvf_at_points, invert_dvf in update_rois/
        # update_dose) index fields axis-aligned as (p - origin) /
        # spacing — evaluating on an oblique lattice would mis-register
        # every downstream warp while the residuals below still read ~0
        dvf = tps_displacement_grid(p, W, A, ref.origin, ref.spacing,
                                    np.eye(3), ref.array.shape,
                                    chunk=chunk)
        # already point-displacement — no solver-field inversion needed
        self.dvf = dvf
        self.origin = np.asarray(ref.origin, np.float64)
        self.spacing = tuple(np.asarray(ref.spacing, np.float64))
        self.dimensions = np.asarray(dvf.shape[:3])
        self.display.compute_scroll_max()
        self.update_rois()

        fitted = np.asarray(tps_displacement(p, W, A,
                                             p.astype(np.float32)))
        residual = np.linalg.norm(p + fitted - t, axis=1)
        return {n: float(r) for n, r in zip(names, residual)}

    @staticmethod
    def correct_dvf_direction(dvf, spacing, origin, matrix):
        """Rotate field vectors to identity direction about the volume
        center, rewriting the origin
        (reference structure/deformable.py:693-730)."""
        D_new = np.identity(3)
        R = D_new @ np.linalg.inv(matrix)

        center_index = (np.flip(np.asarray(dvf.shape))[1:] - 1) / 2.0
        center_phys = np.asarray(origin) + np.asarray(matrix) @ (
            center_index * np.asarray(spacing))

        Z, Y, X, _ = dvf.shape
        dvf_rotated = (R @ dvf.reshape(-1, 3).T).T.reshape(Z, Y, X, 3)

        origin_new = center_phys - D_new @ (center_index
                                            * np.asarray(spacing))
        return dvf_rotated, spacing, origin_new, dvf_rotated.shape[0:3]

    def _warp_resampled_to_reference(self, resampled, background,
                                     ratio=1):
        """Invert the DVF and warp a volume already rigid-resampled
        onto the reference grid (shared by create_image /
        update_dose). Both stages are grid warps (ops/warp.py)."""
        dvf = np.asarray(self.dvf) * float(ratio)
        inv = invert_dvf(dvf, self.spacing)

        import jax
        import jax.numpy as jnp

        from ..ops.warp import affine_coords, field_warp, warp_disp

        ref = Data.image[self.reference_name]
        ref_p2p = geo.pixel_to_position_matrix(ref.matrix, ref.spacing,
                                               ref.origin)
        Z, Y, X = resampled.shape
        # ref voxel -> DVF-grid pixel coords (DVF grid is axis-aligned
        # with self.origin/self.spacing, reference read/dicom.py:1766)
        dvf_pos2pix = geo.position_to_pixel_matrix(
            np.eye(3), self.spacing, self.origin)
        cz, cy, cx = affine_coords(
            (dvf_pos2pix @ ref_p2p).astype(np.float32), (Z, Y, X))
        disp = field_warp(jnp.moveaxis(jnp.asarray(inv, jnp.float32),
                                       -1, 0), cz, cy, cx,
                          background=0.0)           # (3,Z,Y,X) mm xyz
        # displaced ref-pixel sample coords: pix + L @ disp (L = linear
        # part of position->pixel; pos2pix(pos)=pix grid identity here).
        # HIGHEST: a TF32 product moves the sample point by ~1e-3 voxel
        L = np.asarray(geo.position_to_pixel_matrix(
            ref.matrix, ref.spacing, ref.origin))[:3, :3] \
            .astype(np.float32)
        disp_pix = jnp.einsum("ij,jzyx->izyx", jnp.asarray(L), disp,
                              precision=jax.lax.Precision.HIGHEST)
        return np.asarray(warp_disp(
            jnp.asarray(resampled, jnp.float32), disp_pix,
            background=background))

    def create_image(self, ratio=1):
        """Rigid resample -> invert DVF -> displacement warp
        (reference structure/deformable.py:732-774; `ratio` honored
        here, scaling the field)."""
        ref = Data.image[self.reference_name]
        mov = Data.image[self.moving_name]

        A = compose_pixel_matrix(mov.matrix, mov.spacing, mov.origin,
                                 ref.matrix, ref.spacing, ref.origin,
                                 phys_transform=self.rigid_matrix)
        resampled = np.asarray(affine_resample(
            np.asarray(mov.array, np.float32), A, ref.array.shape,
            background=config.background_fill))

        warped = self._warp_resampled_to_reference(
            resampled, config.background_fill, ratio=ratio)
        return {"array": warped, "origin": np.asarray(ref.origin),
                "spacing": np.asarray(ref.spacing),
                "direction": np.asarray(ref.matrix)}

    def update_dose(self, dose_name=None, ratio=1):
        """Warp a dose grid tied to the moving image through
        rigid + DVF onto the reference image grid — the dose-warping
        building block of adaptive-RT dose accumulation
        (BEYOND-PARITY: the reference's Deformable only warps ROI
        meshes, structure/deformable.py:961-1001; see
        utils/dose.accumulate_dose for the multi-fraction sum).
        Returns a reference-grid volume dict; background is 0 Gy."""
        if dose_name is None:
            mov = Data.image[self.moving_name]
            candidates = [n for n, d in Data.dose.items()
                          if d.frame_ref == mov.frame_ref]
            if not candidates:
                raise ValueError(
                    "update_dose: no dose shares the moving image's "
                    "FrameOfReferenceUID; pass dose_name explicitly")
            if len(candidates) > 1:
                raise ValueError(
                    "update_dose: multiple doses share the moving "
                    f"image's FrameOfReferenceUID ({candidates}); "
                    "pass dose_name explicitly")
            dose_name = candidates[0]
        dose = Data.dose[dose_name]

        ref = Data.image[self.reference_name]
        A = compose_pixel_matrix(dose.matrix, dose.spacing, dose.origin,
                                 ref.matrix, ref.spacing, ref.origin,
                                 phys_transform=self.rigid_matrix)
        resampled = np.asarray(affine_resample(
            np.asarray(dose.array, np.float32), A, ref.array.shape,
            background=0.0))

        warped = self._warp_resampled_to_reference(resampled, 0.0,
                                                   ratio=ratio)
        return {"array": warped, "origin": np.asarray(ref.origin),
                "spacing": np.asarray(ref.spacing),
                "direction": np.asarray(ref.matrix),
                "dose_name": dose_name}

    def update_mask(self, mask, ratio=1, threshold=0.5):
        """Warp a moving-image-grid binary mask onto the reference
        grid — BEYOND-PARITY contour propagation on voxels (the
        reference only warps ROI meshes, structure/deformable.py:
        961-1001; mesh warping loses holes/topology that voxel
        indicator warping keeps). Rigid resample + field warp of the
        float indicator through the shared warp stages, then
        ``>= threshold``. Returns a (Z, Y, X) uint8 mask on the
        reference grid."""
        if self.dvf is None:
            raise ValueError("update_mask: no DVF computed yet")
        ref = Data.image[self.reference_name]
        mov = Data.image[self.moving_name]
        mask = np.asarray(mask, np.float32)
        expect = tuple(int(v) for v in mov.dimensions)
        if mask.shape != expect:
            raise ValueError(
                f"update_mask: mask shape {mask.shape} != moving "
                f"image grid {expect}")

        A = compose_pixel_matrix(mov.matrix, mov.spacing, mov.origin,
                                 ref.matrix, ref.spacing, ref.origin,
                                 phys_transform=self.rigid_matrix)
        resampled = np.asarray(affine_resample(
            mask, A, tuple(int(v) for v in ref.dimensions),
            background=0.0))
        warped = self._warp_resampled_to_reference(resampled, 0.0,
                                                   ratio=ratio)
        return (warped >= float(threshold)).astype(np.uint8)

    def update_pois(self, poi_name=None, percent=100):
        """Propagate the moving image's POIs through rigid + field
        into the reference frame — BEYOND-PARITY landmark propagation
        (the reference's Deformable only warps ROI meshes,
        structure/deformable.py:961-1001). Same composition as
        update_rois: inv(rigid) then + d(p). Returns
        {name: (3,) position mm} and caches it on ``self.pois``;
        pair with utils.metrics.target_registration_error for TRE."""
        if self.dvf is None:
            raise ValueError("update_pois: no DVF computed yet")
        if self.moving_name is None \
                or self.moving_name not in Data.image:
            return {}
        rigid_inv = np.linalg.inv(np.asarray(self.rigid_matrix,
                                             np.float64))
        names, pts = [], []
        for name, poi in Data.image[self.moving_name].pois.items():
            if poi_name is not None and name != poi_name:
                continue
            if poi.point_position is None:
                continue
            p = np.asarray(poi.point_position, np.float64)
            names.append(name)
            pts.append((rigid_inv @ np.append(p, 1.0))[:3])
        out = {}
        if names:
            pts = np.stack(pts)
            # one batched gather; displacement is linear in the field,
            # so percent scales the sampled result exactly
            disp = np.asarray(sample_dvf_at_points(
                np.asarray(self.dvf), pts, self.origin, self.spacing))
            mapped = pts + disp * (percent / 100.0)
            out = {n: mapped[i] for i, n in enumerate(names)}
        if poi_name is None or not hasattr(self, "pois"):
            self.pois = out
        else:
            self.pois.update(out)  # single-POI refresh keeps the rest
        return out

    def compute_jacobian(self):
        """Jacobian-determinant QA map of the deformation T(p) = p +
        d(p) — BEYOND-PARITY: standard deformable-registration QA
        (det <= 0 marks folding; a field that folds must not be used
        for dose accumulation). Central differences of the mm
        point-displacement field over the grid spacing, one jitted
        device program. Returns {'det': (Z, Y, X) float32,
        'folding_fraction', 'det_min', 'det_max', 'det_mean'}."""
        if self.dvf is None:
            raise ValueError("compute_jacobian: no DVF computed yet")
        if any(int(s) < 2 for s in np.shape(self.dvf)[:3]):
            raise ValueError(
                "compute_jacobian: every grid axis needs >= 2 samples "
                f"for finite differences, got {np.shape(self.dvf)[:3]}")
        import jax.numpy as jnp

        inv_sp = np.asarray(
            [1.0 / float(v) for v in self.spacing], np.float32)
        det = np.asarray(_jacobian_det(
            jnp.asarray(self.dvf, jnp.float32), jnp.asarray(inv_sp)))
        return {
            "det": det,
            "folding_fraction": float((det <= 0).mean()),
            "det_min": float(det.min()),
            "det_max": float(det.max()),
            "det_mean": float(det.mean()),
        }

    def create_reg(self, path=None):
        """Build a DICOM Deformable Spatial Registration (REG) dataset
        from this field — BEYOND-PARITY: the reference can only read
        deformable REG objects (read/dicom.py:1688-1786); exporting a
        computed DVF to a TPS needs a writer. Emits the structure
        ReadREG consumes: ReferencedSeriesSequence (reference, moving),
        PreDeformationMatrixRegistrationSequence with
        inv(self.rigid_matrix) (the reader inverts back), and the grid
        (axis-aligned orientation, origin, GridDimensions (x, y, z),
        GridResolution, float32-LE VectorGridData in our (Z, Y, X, 3)
        point-displacement layout). Returns the Dataset; writes a
        Part-10 file when ``path`` is given."""
        from ..dicom import Dataset, Sequence, dcmwrite
        from ..dicom import uids
        from .common import build_reg_dataset

        if self.dvf is None:
            raise ValueError("create_reg: no DVF computed yet")
        if self.reference_name not in Data.image \
                or self.moving_name not in Data.image:
            raise ValueError(
                "create_reg: reference and moving images must both be "
                "loaded to reference their series/SOPs")
        ref = Data.image[self.reference_name]
        mov = Data.image[self.moving_name]
        ds = build_reg_dataset(
            uids.DeformableSpatialRegistrationStorage, ref, mov,
            self.deformable_name)

        pre = Dataset()
        pre.FrameOfReferenceTransformationMatrix = [
            float(v) for v in np.linalg.inv(
                np.asarray(self.rigid_matrix, np.float64)).reshape(-1)]
        pre.FrameOfReferenceTransformationMatrixType = "RIGID"

        dvf = np.ascontiguousarray(np.asarray(self.dvf, "<f4"))
        grid = Dataset()
        grid.ImageOrientationPatient = [1, 0, 0, 0, 1, 0]
        grid.ImagePositionPatient = [float(v) for v in self.origin]
        grid.GridDimensions = [int(dvf.shape[2]), int(dvf.shape[1]),
                               int(dvf.shape[0])]       # (x, y, z)
        grid.GridResolution = [float(v) for v in self.spacing]
        grid.VectorGridData = dvf.tobytes()
        dreg = Dataset()
        dreg.SourceFrameOfReferenceUID = mov.frame_ref
        dreg.PreDeformationMatrixRegistrationSequence = Sequence([pre])
        dreg.DeformableRegistrationGridSequence = Sequence([grid])
        ds.DeformableRegistrationSequence = Sequence([dreg])

        if path is not None:
            dcmwrite(path, ds)
        return ds

    def export_image(self, path=None):
        """(reference structure/deformable.py:776-788)."""
        if self.moving_name is not None and path is not None:
            out = self.create_image()
            from ..read.mhd import write_mhd_volume
            write_mhd_volume(path, out["array"], spacing=out["spacing"],
                             origin=out["origin"])

    # -- view queries (reference structure/deformable.py:790-937) -------
    def retrieve_array_plane(self, slice_plane, solo=None, position=None,
                             vector=None):
        if len(self.display.array) == 0:
            self.display.compute_deformation()
            self.display.compute_slice_location()
        if solo is None:
            self.display.compute_slice_location(position=position)
        if vector is None:
            return self.display.compute_array(slice_plane)
        if vector in ("x", "y", "z"):
            return self.display.compute_grid(slice_plane=slice_plane,
                                             vector=vector)
        return None

    def retrieve_grid(self, slice_plane="Axial", vector="x"):
        return self.display.compute_grid(slice_plane=slice_plane,
                                         vector=vector)

    def retrieve_offset(self, slice_plane):
        return self.display.offset[slice_plane]

    def retrieve_slice_location(self, slice_plane):
        if slice_plane == "Axial":
            return self.display.slice_location[0]
        if slice_plane == "Coronal":
            return self.display.slice_location[1]
        return self.display.slice_location[2]

    def retrieve_slice_position(self, slice_plane=None):
        m = self.display.compute_matrix_pixel_to_position()
        if slice_plane is None:
            location = [self.display.slice_location[2],
                        self.display.slice_location[1],
                        self.display.slice_location[0]]
        elif slice_plane == "Axial":
            location = [0, 0, self.display.slice_location[0]]
        elif slice_plane == "Coronal":
            location = [0, self.display.slice_location[1], 0]
        else:
            location = [self.display.slice_location[2], 0, 0]
        return geo.apply_homogeneous(location, m)

    def retrieve_scroll_max(self, slice_plane):
        if slice_plane == "Axial":
            return self.display.scroll_max[0]
        if slice_plane == "Coronal":
            return self.display.scroll_max[1]
        return self.display.scroll_max[2]

    def save_deformable(self, path):
        """json metadata + dvf.npy (replaces the reference's pickled
        DataFrame, structure/deformable.py:939-959)."""
        os.makedirs(str(path), exist_ok=True)
        payload = {
            "deformable_name": self.deformable_name,
            "reference_name": self.reference_name,
            "moving_name": self.moving_name,
            "roi_names": list(self.roi_names or []),
            "origin": np.asarray(self.origin, dtype=float).tolist(),
            "spacing": np.asarray(self.spacing, dtype=float).tolist(),
            "dimensions": np.asarray(self.dimensions).astype(int).tolist()
            if self.dimensions is not None else None,
            "rigid_matrix": np.asarray(self.rigid_matrix).tolist(),
        }
        with open(os.path.join(str(path), "deformable.json"), "w") as f:
            json.dump(payload, f, indent=1)
        np.save(os.path.join(str(path), "dvf.npy"), self.dvf)

    @classmethod
    def load_deformable(cls, path):
        """Load a :meth:`save_deformable` directory back into
        ``Data.deformable`` — NEW load side (the reference only ever
        saved; symmetric with Image.load_image / Rigid.load_rigid).
        Registered under the saved name (collision-suffixed by
        add_deformable when taken)."""
        with open(os.path.join(str(path), "deformable.json")) as f:
            payload = json.load(f)
        dvf_path = os.path.join(str(path), "dvf.npy")
        dvf = np.load(dvf_path) if os.path.exists(dvf_path) else None
        from .common import collision_suffix
        name = payload.get("deformable_name")
        if name is not None:
            # suffix the SAVED name ('Fraction2_DVF' -> '..._1') —
            # handing None to add_deformable would re-derive a generic
            # 'DVF_{ref}_{mov}' / 'DVF_Unknown' name, losing provenance
            name = collision_suffix(name, Data.deformable_list)
        return cls(
            dvf=dvf,
            origin=(np.asarray(payload["origin"], np.float64)
                    if payload.get("origin") is not None else None),
            spacing=(tuple(payload["spacing"])
                     if payload.get("spacing") is not None else None),
            dimensions=(np.asarray(payload["dimensions"])
                        if payload.get("dimensions") is not None
                        else None),
            roi_names=payload.get("roi_names") or [],
            rigid_matrix=np.asarray(payload.get("rigid_matrix",
                                                np.eye(4)), np.float64),
            registration_name=name,
            reference_name=payload.get("reference_name"),
            moving_name=payload.get("moving_name"))

    def update_rois(self, roi_name=None, percent=100):
        """Warp visible moving ROI meshes through the field
        (reference structure/deformable.py:961-1001)."""
        for name in list(self.rois.keys()):
            if name not in Data.roi_list:
                del self.rois[name]
        for name in Data.roi_list:
            if name not in self.rois:
                self.rois[name] = None
                self.rigid_rois[name] = None

        if self.moving_name is None \
                or self.moving_name not in Data.image:
            return

        for name in Data.roi_list:
            if roi_name is None or name == roi_name:
                roi = Data.image[self.moving_name].rois.get(name)
                if roi is not None and roi.mesh is not None and roi.visible:
                    self.rigid_rois[name] = roi.mesh.transform(
                        np.linalg.inv(self.rigid_matrix), inplace=False)
                    points = self.rigid_rois[name].points
                    disp = sample_dvf_at_points(
                        np.asarray(self.dvf) * (percent / 100.0), points,
                        self.origin, self.spacing)
                    deformed = copy.deepcopy(self.rigid_rois[name])
                    deformed.points = points + disp
                    self.rois[name] = deformed
