"""Image domain object + Display view state.

Behavior-parity rebuild of reference structure/image.py:39-1411. The 4x4
transform math lives in ops/geometry (canonical); the off-axis reslice
runs on device through ops/resample.reslice_rotation instead of VTK.
"""

from __future__ import annotations

import copy
import itertools
import os
import json

import numpy as np

from ..config import config
from ..data import Data
from ..dicom import generate_uid
from ..ops import geometry as geo
from .common import (GeometryQueriesMixin, MetadataMixin, ViewOpsMixin)
from .poi import Poi
from .roi import Roi

__all__ = ["Display", "Image"]

# Process-global monotonic ids for the ROI mask cache — never reused,
# unlike id(), which CPython recycles after a Roi is freed.
_ROI_CACHE_TOKENS = itertools.count(1)


class Display(object):
    """Slice viewing state + coordinate spaces + off-axis reslicing
    (reference structure/image.py:39-306)."""

    def __init__(self, image):
        self.image = image

        self.matrix = copy.deepcopy(self.image.matrix)
        self.spacing = copy.deepcopy(self.image.spacing)
        self.origin = copy.deepcopy(self.image.origin)

        self.slice_location = self.image.compute_center(position=False,
                                                        zyx=True)
        self.scroll_max = [self.image.dimensions[0] - 1,
                           self.image.dimensions[1] - 1,
                           self.image.dimensions[2] - 1]
        self.secondary_array = None
        self.misc = {}

    def compute_matrix_pixel_to_position(self):
        return geo.pixel_to_position_matrix(self.matrix, self.spacing,
                                            self.origin)

    def compute_matrix_position_to_pixel(self):
        return geo.position_to_pixel_matrix(self.matrix, self.spacing,
                                            self.origin)

    def compute_array(self, slice_plane):
        """2D slice at the current slice_location on a standard plane."""
        source = self.image.array if self.secondary_array is None \
            else self.secondary_array
        if slice_plane == "Axial":
            array = source[self.slice_location[0], :, :]
        elif slice_plane == "Coronal":
            array = source[:, self.slice_location[1], :]
        else:
            array = source[:, :, self.slice_location[2]]
        return np.asarray(array).astype(np.float32)

    def compute_index_positions(self, xyz):
        m = self.compute_matrix_pixel_to_position()
        return geo.apply_homogeneous([xyz[0], xyz[1], xyz[2]], m)

    def compute_offaxis_array(self):
        """Off-axis reslice through the current display matrix
        (reference structure/image.py:160-215; device kernel instead of
        vtkImageReslice)."""
        from ..ops.resample import reslice_rotation

        loc = np.flip(self.slice_location)
        base_position_matrix = self.compute_matrix_pixel_to_position()
        slice_position = geo.apply_homogeneous(
            [loc[0], loc[1], loc[2]], base_position_matrix)

        resliced, new_origin = reslice_rotation(
            self.image.array, self.image.matrix, self.image.spacing,
            self.image.origin, self.matrix,
            background=config.background_fill)
        self.origin = np.asarray(new_origin)

        dimensions = (resliced.shape[2], resliced.shape[1],
                      resliced.shape[0])
        position_to_pixel_matrix = self.compute_matrix_position_to_pixel()
        location = geo.apply_homogeneous(slice_position,
                                         position_to_pixel_matrix)
        self.slice_location = list(
            np.flip(np.round(location)).astype(np.int32))
        self.scroll_max = [dimensions[2] - 1, dimensions[1] - 1,
                           dimensions[0] - 1]
        for i in range(3):
            if self.slice_location[i] > dimensions[2 - i] - 1:
                self.slice_location[i] = dimensions[2 - i] - 1
            if self.slice_location[i] < 0:
                self.slice_location[i] = 0

        self.secondary_array = resliced

    def compute_scroll_max(self):
        if self.secondary_array is not None:
            self.scroll_max = [self.secondary_array.shape[0] - 1,
                               self.secondary_array.shape[1] - 1,
                               self.secondary_array.shape[2] - 1]
        else:
            self.scroll_max = [self.image.dimensions[0] - 1,
                               self.image.dimensions[1] - 1,
                               self.image.dimensions[2] - 1]

    def compute_slice(self, slice_plane):
        """2D slice + its physical placement (replaces compute_vtk_slice,
        reference structure/image.py:234-284, minus the VTK container)."""
        source = self.image.array if self.secondary_array is None \
            else self.secondary_array
        if slice_plane == "Axial":
            location = [0, 0, self.slice_location[0]]
            array_slice = source[self.slice_location[0], :, :]
        elif slice_plane == "Coronal":
            location = [0, self.slice_location[1], 0]
            array_slice = source[:, self.slice_location[1], :]
        else:
            location = [self.slice_location[2], 0, 0]
            array_slice = source[:, :, self.slice_location[2]]
        m = self.compute_matrix_pixel_to_position()
        origin = geo.apply_homogeneous(location, m)
        return {"array": np.asarray(array_slice), "origin": origin,
                "spacing": self.spacing, "matrix": self.matrix}

    # kept as alias for API familiarity
    compute_vtk_slice = compute_slice

    def update_slice_location(self, scroll, slice_plane):
        if slice_plane == "Axial":
            self.slice_location[0] = scroll
        elif slice_plane == "Coronal":
            self.slice_location[1] = scroll
        else:
            self.slice_location[2] = scroll


class Image(MetadataMixin, GeometryQueriesMixin, ViewOpsMixin):
    """Volume + identity metadata + geometry + ROI/POI containers
    (reference structure/image.py:309-358). Metadata/geometry/view
    machinery shared with Dose via structure/common.py mixins."""

    def __init__(self, image):
        self.rois = {}
        self.pois = {}

        self.tags = image.image_set
        self.array = image.array

        self.image_name = image.image_name
        self.modality = image.modality

        self.patient_name = self.get_patient_name()
        self.mrn = self.get_mrn()
        self.birthdate = self.get_birthdate()
        self.date = self.get_date()
        self.time = self.get_time()
        self.local_uid = generate_uid()
        self.series_uid = self.get_series_uid()
        self.acq_number = self.get_acq_number()
        self.frame_ref = self.get_frame_ref()
        self.window = self.get_window()

        self.filepaths = image.filepaths
        self.sops = image.sops

        self.plane = image.plane
        self.spacing = image.spacing
        self.dimensions = image.dimensions
        self.orientation = image.orientation
        self.origin = image.origin
        self.matrix = image.image_matrix

        self.unverified = image.unverified
        self.skipped_slice = image.skipped_slice
        self.rgb = image.rgb

        self.camera_position = None

        self.visual = {"colormap": "gray", "bounds": None}
        self.misc = {}

        self.display = Display(self)

    # -- intake --------------------------------------------------------
    def input_mhd(self, filename, roi_names, values, plane="Axial"):
        """Label volume -> per-label ROI masks (reference
        structure/image.py:360-387; own MHD reader instead of sitk)."""
        from ..read.mhd import read_mhd_volume

        roi_array, _, _, _ = read_mhd_volume(filename)
        for ii, roi_name in enumerate(roi_names):
            if roi_name not in self.rois:
                self.rois[roi_name] = Roi(self, name=roi_name, visible=True,
                                          filepaths=filename, plane=plane)
            roi_mask = roi_array == values[ii]
            self.rois[roi_name].convert_mask(roi_mask)

    def input_rtstruct(self, rtstruct):
        """Populate ROIs/POIs from a parsed RTSTRUCT (reference
        structure/image.py:389-413)."""
        for ii, roi_name in enumerate(rtstruct.roi_names):
            if roi_name not in self.rois \
                    or self.rois[roi_name].contour_position is None:
                self.rois[roi_name] = Roi(
                    self, position=rtstruct.contours[ii], name=roi_name,
                    color=rtstruct.roi_colors[ii], visible=False,
                    filepaths=rtstruct.filepaths)

        for ii, poi_name in enumerate(rtstruct.poi_names):
            if poi_name not in self.pois \
                    or self.pois[poi_name].point_position is None:
                self.pois[poi_name] = Poi(
                    self, position=rtstruct.points[ii], name=poi_name,
                    color=rtstruct.poi_colors[ii], visible=False,
                    filepaths=rtstruct.filepaths)

        Data.match_rois()
        Data.match_pois()

    def input_seg(self, seg):
        """Populate ROIs from a parsed DICOM SEG (read/seg.py) —
        BEYOND-PARITY: the reference has no SEG support. Masks route
        through the same convert_mask path input_mhd uses, so the ROIs
        behave identically to RTSTRUCT/MHD ones downstream."""
        for ii, roi_name in enumerate(seg.roi_names):
            if not (roi_name not in self.rois
                    or self.rois[roi_name].contour_position is None):
                continue
            self.rois[roi_name] = Roi(
                self, name=roi_name, color=seg.roi_colors[ii],
                visible=False, filepaths=seg.filepaths)
            if ii < len(seg.masks):
                self.rois[roi_name].convert_mask(seg.masks[ii])
        Data.match_rois()

    def add_roi(self, roi_name=None, color=None, visible=False, path=None,
                contour=None, plane="Axial"):
        self.rois[roi_name] = Roi(self, position=contour, name=roi_name,
                                  color=color, visible=visible,
                                  filepaths=path, plane=plane)
        Data.match_rois()

    def add_poi(self, poi_name=None, color=None, visible=False, path=None,
                point=None):
        self.pois[poi_name] = Poi(self, position=point, name=poi_name,
                                  color=color, visible=visible,
                                  filepaths=path)
        Data.match_pois()

    def create_roi(self, name=None, color=None, visible=False, filepath=None):
        self.rois[name] = Roi(self, name=name, color=color, visible=visible,
                              filepaths=filepath)
        Data.match_rois()

    def create_rtstruct(self, roi_names=None, poi_names=None, path=None,
                        label="medicalimageanalysis_tpu"):
        """Build an RTSTRUCT dataset from this image's ROIs/POIs
        (implemented — the reference keeps an empty stub at
        structure/image.py:488-503). Returns the Dataset; writes a
        Part-10 file when `path` is given."""
        from ..dicom import Dataset, Sequence, dcmwrite, generate_uid
        from ..dicom import uids

        if roi_names is None:
            roi_names = [n for n, r in self.rois.items()
                         if r.contour_position is not None]
        if poi_names is None:
            poi_names = [n for n, p in self.pois.items()
                         if p.point_position is not None]

        ds = Dataset()
        ds.SOPClassUID = uids.RTStructureSetStorage
        ds.SOPInstanceUID = generate_uid()
        ds.Modality = "RTSTRUCT"
        ds.StructureSetLabel = label
        ds.PatientID = self.mrn if self.mrn != "missing" else ""
        if isinstance(self.patient_name, list):
            ds.PatientName = "^".join(self.patient_name)
        ds.SeriesInstanceUID = generate_uid()
        ds.StudyInstanceUID = self.get_study_uid()
        ds.FrameOfReferenceUID = self.frame_ref

        # referenced frame-of-reference chain
        series_item = Dataset()
        series_item.SeriesInstanceUID = self.series_uid
        imgs = Sequence()
        for sop in (self.sops or []):
            r = Dataset()
            r.ReferencedSOPClassUID = uids.MODALITY_SOP_CLASS.get(
                self.modality, uids.CTImageStorage)
            r.ReferencedSOPInstanceUID = sop
            imgs.append(r)
        series_item.ContourImageSequence = imgs
        study_item = Dataset()
        study_item.RTReferencedSeriesSequence = Sequence([series_item])
        for_item = Dataset()
        for_item.ReferencedFrameOfReferenceUID = self.frame_ref
        for_item.RTReferencedStudySequence = Sequence([study_item])
        ds.ReferencedFrameOfReferenceSequence = Sequence([for_item])

        m = self.display.compute_matrix_position_to_pixel()
        sop_class = uids.MODALITY_SOP_CLASS.get(self.modality,
                                                uids.CTImageStorage)

        roi_seq = Sequence()
        contour_seq = Sequence()
        obs_seq = Sequence()
        number = 0
        for name in list(roi_names) + list(poi_names):
            number += 1
            s = Dataset()
            s.ROINumber = number
            s.ROIName = name
            s.ReferencedFrameOfReferenceUID = self.frame_ref
            s.ROIGenerationAlgorithm = "MANUAL"
            roi_seq.append(s)

            obs = Dataset()
            obs.ObservationNumber = number
            obs.ReferencedROINumber = number
            obs.RTROIInterpretedType = "ORGAN" if name in roi_names \
                else "MARKER"
            obs_seq.append(obs)

            item = Dataset()
            item.ReferencedROINumber = number
            cs = Sequence()
            if name in self.rois and name in roi_names:
                roi = self.rois[name]
                item.ROIDisplayColor = [int(v) for v in
                                        (roi.color or [128, 128, 128])]
                for contour in (roi.contour_position or []):
                    contour = np.asarray(contour, dtype=float)
                    c = Dataset()
                    c.ContourGeometricType = "CLOSED_PLANAR"
                    c.NumberOfContourPoints = contour.shape[0]
                    c.ContourData = [float(v)
                                     for v in contour.reshape(-1)]
                    # reference the nearest slice SOP by z pixel index
                    pix = geo.apply_homogeneous(contour[0], m)
                    z = int(np.clip(np.round(pix[2]), 0,
                                    len(self.sops or [1]) - 1))
                    if self.sops:
                        ci = Dataset()
                        ci.ReferencedSOPClassUID = sop_class
                        ci.ReferencedSOPInstanceUID = self.sops[z]
                        c.ContourImageSequence = Sequence([ci])
                    cs.append(c)
            else:
                poi = self.pois[name]
                item.ROIDisplayColor = [int(v) for v in
                                        (poi.color or [128, 128, 128])]
                c = Dataset()
                c.ContourGeometricType = "POINT"
                point = np.asarray(poi.point_position,
                                   dtype=float).reshape(-1)
                c.ContourData = [float(v) for v in point[:3]]
                c.NumberOfContourPoints = 1
                cs.append(c)
            item.ContourSequence = cs
            contour_seq.append(item)

        ds.StructureSetROISequence = roi_seq
        ds.ROIContourSequence = contour_seq
        ds.RTROIObservationsSequence = obs_seq

        if path is not None:
            dcmwrite(path, ds)
        return ds

    def compute_suv(self):
        """SUV body-weight map for PT volumes — BEYOND-PARITY: the
        reference ingests PT but offers no SUV conversion (and its
        blanket int16 cast saturates the Bq/mL values SUV needs; PT
        arrays stay float32 here, read/volume3d.py). QIBA / PS3.16
        decay-corrected formula:

            SUVbw = activity[Bq/mL] * weight[g] / decayed_dose[Bq]

        with the injected dose decayed from injection to series time
        for DecayCorrection=START (ADMIN needs no extra factor).
        Requires Units=BQML. Returns a float32 (Z, Y, X) map."""
        if self.modality != "PT":
            raise ValueError("compute_suv: PT volumes only, this "
                             f"image is {self.modality}")
        ds = self.tags[0]
        units = str(ds.get("Units", "") or "")
        if units != "BQML":
            raise ValueError(
                f"compute_suv: Units={units or '<missing>'} — only "
                "BQML (decay-corrected activity concentration) is "
                "convertible")
        seq = getattr(ds, "RadiopharmaceuticalInformationSequence",
                      None)
        if not seq:
            raise ValueError("compute_suv: no Radiopharmaceutical"
                             "InformationSequence")
        info = seq[0]
        dose = info.get("RadionuclideTotalDose")
        half_life = info.get("RadionuclideHalfLife")
        weight = ds.get("PatientWeight")
        for name, v in (("RadionuclideTotalDose", dose),
                        ("RadionuclideHalfLife", half_life),
                        ("PatientWeight", weight)):
            if v is None:
                raise ValueError(f"compute_suv: missing {name}")
        dose, half_life = float(dose), float(half_life)
        weight_g = float(weight) * 1000.0

        def tm_seconds(t):
            # TM "HHMMSS.frac" with legal truncations (PS3.5 6.2);
            # DT offsets are stripped by dt_time before slicing
            t = str(t).strip()
            hh = int(t[0:2]) if len(t) >= 2 else 0
            mm = int(t[2:4]) if len(t) >= 4 else 0
            ss = float(t[4:]) if len(t) > 4 else 0.0
            return hh * 3600 + mm * 60 + ss

        def dt_time(t):
            # DT "YYYYMMDDHHMMSS.frac&ZZXX": strip the UTC offset
            # suffix (scan/injection share the site clock, so the
            # offset cancels in the difference), then the date part
            t = str(t).strip()
            for sign in ("+", "-"):
                cut = t.find(sign)
                if cut > 0:
                    t = t[:cut]
                    break
            return t[8:]

        decay = str(ds.get("DecayCorrection", "START") or "START")
        if decay == "ADMIN":
            decayed_dose = dose
        elif decay == "START":
            start_dt = info.get("RadiopharmaceuticalStartDateTime")
            start_tm = info.get("RadiopharmaceuticalStartTime")
            if start_dt:
                inj_s = tm_seconds(dt_time(start_dt))
            elif start_tm is not None:
                inj_s = tm_seconds(start_tm)
            else:
                raise ValueError("compute_suv: missing "
                                 "radiopharmaceutical start time")
            scan = ds.get("SeriesTime")
            if scan is None:
                # earliest acquisition across slices (QIBA scan-start
                # reference; tags[0] is position-sorted, not
                # time-sorted — multi-bed PT can differ by minutes)
                acqs = [s.get("AcquisitionTime") for s in self.tags]
                acqs = [a for a in acqs if a is not None]
                if not acqs:
                    raise ValueError("compute_suv: missing SeriesTime/"
                                     "AcquisitionTime")
                scan = min(acqs, key=tm_seconds)
            dt = tm_seconds(scan) - inj_s
            if dt < 0:  # crossed midnight (times are date-less TM)
                dt += 86400.0
            decayed_dose = dose * 2.0 ** (-dt / half_life)
        else:
            raise ValueError(
                f"compute_suv: DecayCorrection={decay} not supported "
                "(START or ADMIN)")
        return np.asarray(self.array, np.float32) \
            * np.float32(weight_g / decayed_dose)

    def create_roi_from_margin(self, name, source, margin_mm,
                               color=None, backend="scipy"):
        """New ROI = ``source`` expanded/contracted by an exact
        Euclidean mm margin (scalar or per-axis [mx, my, mz]; negative
        contracts) — BEYOND-PARITY planning structure generation
        (PTV = CTV + margin). backend='device' runs the EDT on the
        accelerator (ops/edt.py). Returns the new Roi."""
        from ..utils.roi.margin import expand_mask

        mask = expand_mask(self.rois[source].compute_mask(),
                           self.spacing, margin_mm, backend=backend)
        self.create_roi(name=name,
                        color=color or self.rois[source].color)
        self.rois[name].convert_mask(mask)
        return self.rois[name]

    def create_roi_from_boolean(self, name, op, roi_a, roi_b,
                                color=None):
        """New ROI = boolean combination of two ROIs ('union' |
        'intersect' | 'subtract' | 'xor') — BEYOND-PARITY (ring
        structures, PTV-minus-OAR overlap resolution). Returns the
        new Roi."""
        from ..utils.roi.margin import combine_masks

        mask = combine_masks(op, self.rois[roi_a].compute_mask(),
                             self.rois[roi_b].compute_mask())
        self.create_roi(name=name,
                        color=color or self.rois[roi_a].color)
        self.rois[name].convert_mask(mask)
        return self.rois[name]

    def resample_to(self, other, values=None, background=-3001.0):
        """Resample this image's volume onto another image's grid —
        BEYOND-PARITY convenience (the reference would need the full
        sitk.Resample dance; here one composed pixel->pixel matrix
        feeds the affine warp). Both grids must share a frame
        of reference (same-study CT/PT/MR or dose grids); for
        cross-study resampling compose a Rigid and use
        Rigid.create_image.

        other: Image/Dose object or a registered image name;
        values: optional voxel-aligned map to resample instead of
        ``self.array`` (e.g. a SUV map or an ROI mask — pass
        ``background=0`` for masks). Returns float32 on the other
        grid."""
        from ..data import Data
        from ..ops.resample import affine_resample, compose_pixel_matrix

        if isinstance(other, str):
            other = Data.image[other]
        vals = np.asarray(self.array if values is None else values,
                          np.float32)
        if vals.shape != tuple(self.dimensions):
            raise ValueError(
                f"resample_to: values shape {vals.shape} != image "
                f"grid {tuple(self.dimensions)}")
        A = compose_pixel_matrix(self.matrix, self.spacing, self.origin,
                                 other.matrix, other.spacing,
                                 other.origin)
        return np.asarray(affine_resample(
            vals, A, tuple(int(n) for n in other.dimensions),
            background=float(background)), np.float32)

    def compute_roi_statistics(self, roi_name, values=None):
        """First-order statistics of a value map inside an ROI —
        BEYOND-PARITY (the reference only has the dose-specific
        variant, structure/dose.py:774-816): HU stats on CT, SUV stats
        on PT (pass ``values=img.compute_suv()``), anything
        voxel-aligned. Returns min/max/mean/median/std + volume_cc +
        voxel count."""
        mask = np.asarray(self.rois[roi_name].compute_mask()) > 0
        vals = np.asarray(self.array if values is None else values,
                          np.float32)
        if vals.shape != mask.shape:
            raise ValueError(
                f"compute_roi_statistics: values shape {vals.shape} "
                f"!= image grid {mask.shape}")
        inside = vals[mask]
        from ..utils.metrics import voxel_volume_cc
        voxel_cc = voxel_volume_cc(self.spacing)
        empty = inside.size == 0
        nan = float("nan")
        # schema is identical for empty ROIs (NaN stats) so tabulating
        # consumers never KeyError
        return {
            "ROI": roi_name,
            "voxels": int(inside.size),
            "volume_cc": float(inside.size * voxel_cc),
            "min": nan if empty else float(inside.min()),
            "max": nan if empty else float(inside.max()),
            "mean": nan if empty else float(inside.mean()),
            "median": nan if empty else float(np.median(inside)),
            "std": nan if empty else float(inside.std()),
        }

    def correct_bias(self, mask_roi=None, shrink=4,
                     control_spacing_mm=None, return_field=False,
                     in_place=False, **kwargs):
        """N4-style MR bias field correction — BEYOND-PARITY: the
        reference wraps SimpleITK (which ships
        N4BiasFieldCorrectionImageFilter) but never exposes bias
        correction, and MR needs it before intensity registration /
        histogram matching / radiomics. Device implementation in
        ops/n4.py (exact weighted-least-squares B-spline smoother as
        separable matrix contractions + host histogram sharpening).

        mask_roi: optional ROI name bounding the fit (default: all
        positive voxels); control_spacing_mm: floor of the B-spline
        control spacing in mm (converted per-axis; default 32 voxels);
        in_place: replace ``self.array`` with the corrected map
        (float32). Returns the corrected volume, or (corrected, field)
        with the multiplicative field when ``return_field``."""
        from ..ops.n4 import n4_bias_correction

        mask = None
        if mask_roi is not None:
            mask = np.asarray(self.rois[mask_roi].compute_mask()) > 0
        if control_spacing_mm is not None:
            sx, sy, sz = [float(s) for s in self.spacing]
            kwargs["min_control_spacing"] = [
                control_spacing_mm / sz, control_spacing_mm / sy,
                control_spacing_mm / sx]
        out = n4_bias_correction(self.array, mask=mask, shrink=shrink,
                                 return_field=return_field, **kwargs)
        if in_place:
            self.array = out[0] if return_field else out
        return out

    def compute_mtv_tlg(self, roi_name, suv=None, threshold=2.5,
                        relative=False):
        """Metabolic tumor volume + total lesion glycolysis inside an
        ROI — BEYOND-PARITY PET response metrics (PERCIST/EORTC
        practice). ``threshold`` is an absolute SUV cutoff, or a
        fraction of the ROI SUVmax when ``relative=True`` (the common
        41%-of-max segmentation). Returns {'mtv_cc', 'tlg', 'suv_max',
        'suv_mean_in_mtv', 'threshold'}."""
        if suv is None:
            suv = self.compute_suv()
        suv = np.asarray(suv, np.float32)
        mask = np.asarray(self.rois[roi_name].compute_mask()) > 0
        if suv.shape != mask.shape:
            raise ValueError(
                f"compute_mtv_tlg: SUV shape {suv.shape} != image "
                f"grid {mask.shape}")
        inside = suv[mask]
        if inside.size == 0:
            return {"mtv_cc": 0.0, "tlg": 0.0, "suv_max": 0.0,
                    "suv_mean_in_mtv": 0.0,
                    # relative cuts are undefined without a max
                    "threshold": (float("nan") if relative
                                  else float(threshold))}
        suv_max = float(inside.max())
        cut = float(threshold) * (suv_max if relative else 1.0)
        hot = inside[inside >= cut]
        from ..utils.metrics import voxel_volume_cc
        voxel_cc = voxel_volume_cc(self.spacing)
        mtv_cc = float(hot.size * voxel_cc)
        return {
            "mtv_cc": mtv_cc,
            "tlg": float(hot.sum() * voxel_cc) if hot.size else 0.0,
            "suv_max": suv_max,
            "suv_mean_in_mtv": float(hot.mean()) if hot.size else 0.0,
            "threshold": cut,
        }

    # -- pooled ROI-mask cache (VERDICT r4 #3) ---------------------------
    # Masks are cached bbox-cropped and bit-packed (~organ-volume/8
    # bytes per ROI), keyed on (roi._mask_cache_token, roi._mask_rev)
    # so both wholesale Roi replacement and any contour/mesh/plane
    # rebind (Roi.__setattr__) invalidate. The token is a process-global
    # monotonic id assigned on first cache contact — NOT id(roi):
    # CPython reuses a freed Roi's address, and a replacement Roi built
    # from fresh contours lands on the same deterministic _mask_rev, so
    # an id()-keyed cache can serve the DELETED ROI's mask for the new
    # one. Tokens are never reused, so that aliasing is impossible.
    # Second and subsequent Roi.compute_mask calls on an image cost one
    # unpack (~ms), not a 30-40 ms rasterization.

    @staticmethod
    def _roi_cache_key(roi):
        tok = getattr(roi, "_mask_cache_token", None)
        if tok is None:
            tok = next(_ROI_CACHE_TOKENS)
            object.__setattr__(roi, "_mask_cache_token", tok)
        return (tok, getattr(roi, "_mask_rev", 0))

    def _roi_mask_cache_get(self, name, roi, reconstruct=True):
        cache = getattr(self, "_roi_mask_cache", None)
        ent = cache.get(name) if cache else None
        if ent is None or ent[0] != self._roi_cache_key(roi):
            return None
        if not reconstruct:
            return True
        _, shape, bbox, payload, packed = ent
        out = np.zeros(shape, np.uint8)
        if bbox is not None:
            z0, z1, y0, y1, x0, x1 = bbox
            if packed:
                n = (z1 - z0) * (y1 - y0) * (x1 - x0)
                crop = np.unpackbits(payload, count=n).reshape(
                    z1 - z0, y1 - y0, x1 - x0)
            else:
                crop = payload
            out[z0:z1, y0:y1, x0:x1] = crop
        return out

    def _roi_mask_cache_put(self, name, roi, mask):
        if getattr(self, "_roi_mask_cache", None) is None:
            self._roi_mask_cache = {}
        mask = np.asarray(mask, np.uint8)
        key = self._roi_cache_key(roi)
        zs = np.flatnonzero(mask.any(axis=(1, 2)))
        if zs.size == 0:
            self._roi_mask_cache[name] = (key, mask.shape, None, None,
                                          True)
            return
        ys = np.flatnonzero(mask.any(axis=(0, 2)))
        xs = np.flatnonzero(mask.any(axis=(0, 1)))
        bbox = (int(zs[0]), int(zs[-1]) + 1, int(ys[0]),
                int(ys[-1]) + 1, int(xs[0]), int(xs[-1]) + 1)
        crop = mask[bbox[0]:bbox[1], bbox[2]:bbox[3], bbox[4]:bbox[5]]
        # packbits collapses any nonzero to 1 — only exact for binary
        # masks (every rasterization path emits 0/1); a non-binary
        # mask (hand-assigned labels) caches the raw crop instead
        if crop.max() <= 1:
            payload, packed = np.packbits(crop), True
        else:
            payload, packed = crop.copy(), False
        self._roi_mask_cache[name] = (key, mask.shape, bbox, payload,
                                      packed)

    def compute_roi_masks(self, roi_names=None):
        """Every (or the named) contoured ROI rasterized in ONE pooled
        device pass — BEYOND-PARITY cohort twin of per-ROI
        ``Roi.compute_mask`` (a clinical structure set holds 10-50
        ROIs; the reference loops cv2.fillPoly per ROI per slice).
        Bit-identical to the per-ROI path. Contoured ROIs are grouped
        by slicing plane, one pooled pass per plane present (almost
        always one); ROIs with no contours (mesh-only / stub) fall
        back to their own ``compute_mask``. Each pooled pass takes the
        same backend as the per-ROI path (_pick_raster_backend): where
        that is host cv2, the group loops ``compute_mask`` instead.
        Returns {name: (Z, Y, X) uint8}."""
        from ..parallel.batch import rasterize_batch
        from ..utils.convert.contour import _pick_raster_backend

        names = list(roi_names if roi_names is not None else self.rois)
        dims = tuple(int(v) for v in self.dimensions)
        out = {}
        plane_of = {}
        self._pooled_raster_active = True
        try:
            for n in names:
                roi = self.rois[n]
                cached = self._roi_mask_cache_get(n, roi)
                if cached is not None:
                    out[n] = cached
                elif roi.contour_pixel is not None \
                        and len(roi.contour_pixel):
                    plane_of[n] = roi.plane
                else:
                    out[n] = np.asarray(roi._compute_mask_impl(),
                                        np.uint8)
                    self._roi_mask_cache_put(n, roi, out[n])
            for plane in sorted(set(plane_of.values())):
                group = [n for n in names if plane_of.get(n) == plane]
                if _pick_raster_backend() == "device":
                    masks = rasterize_batch(
                        [self.rois[n].contour_pixel for n in group],
                        dims, plane=plane)
                    for i, n in enumerate(group):
                        out[n] = masks[i]
                else:
                    for n in group:
                        out[n] = np.asarray(
                            self.rois[n]._compute_mask_impl(),
                            np.uint8)
                for n in group:
                    self._roi_mask_cache_put(n, self.rois[n], out[n])
        finally:
            self._pooled_raster_active = False
        return {n: out[n] for n in names}

    def compute_radiomics(self, roi_name, values=None, bin_width=None,
                          n_bins=32, families=None, alpha=0):
        """Full radiomics panel for one ROI — BEYOND-PARITY (the
        reference ecosystem pairs with pyradiomics; here the texture
        matrices are counted on device, ops/radiomics.py). ``values``
        overrides the intensity map (e.g. ``img.compute_suv()`` for
        PET). Discretize with ``bin_width`` (IBSI fixed-bin-size, the
        choice for calibrated HU/SUV) or ``n_bins`` (default 32).
        Returns {family: {feature: value}, 'meta': {...}}."""
        from ..ops.radiomics import ALL_FAMILIES, compute_radiomics
        mask = np.asarray(self.rois[roi_name].compute_mask()) > 0
        vals = np.asarray(self.array if values is None else values,
                          np.float32)
        if vals.shape != mask.shape:
            raise ValueError(
                f"compute_radiomics: values shape {vals.shape} != "
                f"image grid {mask.shape}")
        out = compute_radiomics(
            vals, mask, self.spacing, bin_width=bin_width,
            n_bins=n_bins, alpha=alpha,
            families=ALL_FAMILIES if families is None else families)
        out["meta"]["ROI"] = roi_name
        return out

    def create_seg(self, roi_names=None, path=None, fractional=False,
                   label="medicalimageanalysis_tpu"):
        """Build a DICOM SEG (Segmentation Storage) dataset from this
        image's ROIs — BEYOND-PARITY: the reference has no SEG support
        (it can only represent structures as RTSTRUCT). BINARY 1-bit
        packed frames by default; ``fractional=True`` writes 8-bit
        PROBABILITY frames (mask scaled to MaximumFractionalValue).
        Only non-empty slices are emitted, one frame per (segment,
        slice), per PS3.3 C.8.20. Returns the Dataset; writes a
        Part-10 file when ``path`` is given."""
        from ..dicom import Dataset, Sequence, dcmwrite, generate_uid
        from ..dicom import uids
        from ..read.seg import rgb_to_cielab_uint16

        if roi_names is None:
            roi_names = [n for n, r in self.rois.items()
                         if r.contour_position is not None]
        if not roi_names:
            raise ValueError("create_seg: no ROIs with contours")

        ds = Dataset()
        ds.SOPClassUID = uids.SegmentationStorage
        ds.SOPInstanceUID = generate_uid()
        ds.Modality = "SEG"
        ds.SeriesDescription = label
        ds.ContentLabel = "SEG"
        ds.ContentDescription = label
        ds.ContentCreatorName = "medicalimageanalysis_tpu"
        ds.PatientID = self.mrn if self.mrn != "missing" else ""
        if isinstance(self.patient_name, list):
            ds.PatientName = "^".join(self.patient_name)
        ds.SeriesInstanceUID = generate_uid()
        ds.StudyInstanceUID = self.get_study_uid()
        ds.FrameOfReferenceUID = self.frame_ref

        nz, ny, nx = (int(self.dimensions[0]), int(self.dimensions[1]),
                      int(self.dimensions[2]))
        ds.Rows, ds.Columns = ny, nx
        ds.SamplesPerPixel = 1
        ds.PhotometricInterpretation = "MONOCHROME2"
        ds.PixelRepresentation = 0
        if fractional:
            ds.SegmentationType = "FRACTIONAL"
            ds.SegmentationFractionalType = "PROBABILITY"
            ds.MaximumFractionalValue = 255
            ds.BitsAllocated = ds.BitsStored = 8
            ds.HighBit = 7
        else:
            ds.SegmentationType = "BINARY"
            ds.BitsAllocated = ds.BitsStored = 1
            ds.HighBit = 0

        # referenced source series
        ref_series = Dataset()
        ref_series.SeriesInstanceUID = self.series_uid
        insts = Sequence()
        sop_class = uids.MODALITY_SOP_CLASS.get(self.modality,
                                                uids.CTImageStorage)
        for sop in (self.sops or []):
            r = Dataset()
            r.ReferencedSOPClassUID = sop_class
            r.ReferencedSOPInstanceUID = sop
            insts.append(r)
        ref_series.ReferencedInstanceSequence = insts
        ds.ReferencedSeriesSequence = Sequence([ref_series])

        # shared functional groups: grid geometry — pixel-axis plane
        # tags for the canonical (z, y, x) array (shared writer
        # convention, ops/geometry.grid_plane_tags)
        iop, pixel_spacing = geo.grid_plane_tags(self.matrix,
                                                 self.spacing)
        measures = Dataset()
        measures.PixelSpacing = pixel_spacing
        measures.SliceThickness = float(self.spacing[2])
        measures.SpacingBetweenSlices = float(self.spacing[2])
        orient = Dataset()
        orient.ImageOrientationPatient = iop
        shared = Dataset()
        shared.PixelMeasuresSequence = Sequence([measures])
        shared.PlaneOrientationSequence = Sequence([orient])
        ds.SharedFunctionalGroupsSequence = Sequence([shared])

        # dimension organization (PS3.3 C.7.6.17): frames index by
        # (segment, plane position) — required for strict IOD
        # validation and how viewers (Slicer/OHIF) group frames
        dim_uid = generate_uid()
        dim_org = Dataset()
        dim_org.DimensionOrganizationUID = dim_uid
        ds.DimensionOrganizationSequence = Sequence([dim_org])
        dim_seg = Dataset()
        dim_seg.DimensionOrganizationUID = dim_uid
        dim_seg.DimensionIndexPointer = 0x0062000B  # ReferencedSegmentNumber
        dim_seg.FunctionalGroupPointer = 0x0062000A
        dim_pos = Dataset()
        dim_pos.DimensionOrganizationUID = dim_uid
        dim_pos.DimensionIndexPointer = 0x00200032  # ImagePositionPatient
        dim_pos.FunctionalGroupPointer = 0x00209113
        ds.DimensionIndexSequence = Sequence([dim_seg, dim_pos])

        def _code(value, meaning):
            c = Dataset()
            c.CodeValue = value
            c.CodingSchemeDesignator = "SCT"
            c.CodeMeaning = meaning
            return c

        m = self.display.compute_matrix_pixel_to_position()
        seg_seq = Sequence()
        per_frame = Sequence()
        frame_payloads = []
        for number, name in enumerate(roi_names, start=1):
            roi = self.rois[name]
            s = Dataset()
            s.SegmentNumber = number
            s.SegmentLabel = name
            s.SegmentAlgorithmType = "MANUAL"
            # generic tissue property codes (Type 1 in the Segment
            # Description Macro, PS3.3 C.8.20-2; callers with real
            # anatomy codes can overwrite on the returned Dataset)
            s.SegmentedPropertyCategoryCodeSequence = Sequence(
                [_code("123037004", "Anatomical Structure")])
            s.SegmentedPropertyTypeCodeSequence = Sequence(
                [_code("85756007", "Tissue")])
            s.RecommendedDisplayCIELabValue = rgb_to_cielab_uint16(
                roi.color or [128, 128, 128])
            seg_seq.append(s)

            mask = np.asarray(roi.compute_mask()).astype(np.uint8)
            if mask.shape != (nz, ny, nx):
                raise ValueError(
                    f"create_seg: ROI '{name}' mask shape "
                    f"{mask.shape} != image grid {(nz, ny, nx)}")
            for z in range(nz):
                if not mask[z].any():
                    continue
                item = Dataset()
                ident = Dataset()
                ident.ReferencedSegmentNumber = number
                item.SegmentIdentificationSequence = Sequence([ident])
                content = Dataset()
                content.DimensionIndexValues = [number, z + 1]
                item.FrameContentSequence = Sequence([content])
                plane = Dataset()
                ipp = geo.apply_homogeneous(
                    np.array([0.0, 0.0, float(z)]), m)
                plane.ImagePositionPatient = [float(v) for v in ipp]
                item.PlanePositionSequence = Sequence([plane])
                per_frame.append(item)
                frame_payloads.append(mask[z])

        ds.SegmentSequence = seg_seq
        ds.PerFrameFunctionalGroupsSequence = per_frame
        ds.NumberOfFrames = len(frame_payloads)

        if frame_payloads:
            flat = np.concatenate([f.reshape(-1)
                                   for f in frame_payloads])
        else:
            flat = np.zeros(0, dtype=np.uint8)
        if fractional:
            payload = (flat * 255).astype(np.uint8).tobytes()
        else:
            # contiguous bit packing across frames, LSB-first,
            # end-of-data padding only (PS3.5 8.1.1)
            payload = np.packbits(flat, bitorder="little").tobytes()
        if len(payload) % 2:
            payload += b"\x00"
        ds.PixelData = payload

        if path is not None:
            dcmwrite(path, ds)
        return ds

    def create_nifti(self, path, values=None):
        """Write this volume (or any voxel-aligned ``values`` map —
        SUV, a mask) as NIfTI-1 .nii/.nii.gz — BEYOND-PARITY: the
        deep-learning interchange format (TotalSegmentator/MONAI input
        side; their SEG output comes back through read_dicoms). Exact
        inverse of read/nifti.py: sform carries the full LPS grid, no
        int16 quantization for float maps."""
        from ..read.nifti import write_nifti_volume

        if self.array is None and values is None:
            raise ValueError("no array to export (only_tags image?)")
        arr = np.asarray(self.array if values is None else values)
        if self.array is not None and values is not None \
                and arr.shape != tuple(np.asarray(self.array).shape):
            raise ValueError(
                f"create_nifti: values shape {arr.shape} != image "
                f"grid {np.asarray(self.array).shape}")
        write_nifti_volume(path, arr, self.spacing, self.origin,
                           self.matrix)

    def export_dicom(self, output_dir, description=""):
        """Write this volume back out as a .dcm slice series with its
        real geometry and identity metadata (NEW: the reference can only
        write synthetic series via CreateDicomImage)."""
        from ..utils.creation import CreateDicomImage

        if self.array is None:
            raise ValueError("no array to export (only_tags image?)")
        arr = np.asarray(self.array)
        slope, intercept = 1, 0
        needs_rescale = arr.size and (
            np.issubdtype(arr.dtype, np.floating)
            or float(arr.min()) < -32768 or float(arr.max()) > 32767)
        if needs_rescale:
            # auto-scale into int16 stored values with a slope +
            # intercept that restore physical units on read (the
            # ingest side keeps non-value-preserving rescales in
            # float32, read/volume3d.py). Centering on the intercept
            # uses the full +/-32000 range: half the quantization
            # error of a symmetric zero-intercept slope
            amin, amax = float(arr.min()), float(arr.max())
            if amax > amin:
                slope = (amax - amin) / 64000.0
                intercept = (amax + amin) / 2.0
            else:
                slope, intercept = 1.0, amin
            arr = np.round((arr.astype(np.float64) - intercept)
                           / slope).astype(np.int16)
        # PT SUV inputs ride along so compute_suv works after a
        # round trip (Units/decay/weight/timing/radiopharm info)
        extra = {}
        src = self.tags[0] if self.tags else None
        if src is not None and self.modality == "PT":
            for kw in ("Units", "DecayCorrection", "SeriesTime",
                       "AcquisitionTime", "PatientWeight",
                       "RadiopharmaceuticalInformationSequence"):
                v = src.get(kw) if kw != \
                    "RadiopharmaceuticalInformationSequence" \
                    else getattr(src, kw, None)
                if v is not None:
                    extra[kw] = v
        gen = CreateDicomImage(
            output_dir, arr,
            series=self.series_uid if self.series_uid != "00000.00000"
            else None,
            frame=self.frame_ref if self.frame_ref != "00000.00000"
            else None,
            origin=[float(v) for v in self.origin],
            spacing=[float(self.spacing[0]), float(self.spacing[1])],
            thickness=float(self.spacing[2]))
        # the array is canonical (z, y, x): slices are z-planes, so
        # the written IOP must be the pixel-axis directions (matrix
        # rows 0/1), NOT the acquisition orientation — for a
        # coronal/sagittal-acquired series those differ and the old
        # self.orientation write produced inconsistent geometry
        gen.orientation = geo.grid_plane_tags(self.matrix,
                                              self.spacing)[0]
        name = self.patient_name
        gen.run(patient_name="^".join(name) if isinstance(name, list)
                else str(name),
                patient_id=self.mrn, modality=self.modality,
                description=description, rescale_slope=slope,
                rescale_intercept=intercept, extra_tags=extra)
        return gen

    def load_array(self):
        """Deferred pixel load for images ingested with only_tags=True
        (NEW: completes the only_tags workflow — re-reads the stored
        filepaths, re-assembles on device, fills self.array)."""
        if self.array is not None:
            return self.array
        if not self.filepaths or any(f is None for f in self.filepaths):
            raise ValueError("no filepaths recorded; cannot load array")
        from ..dicom import dcmread
        from ..read.volume3d import Read3D

        try:
            datasets = [dcmread(f) for f in self.filepaths]
            by_sop = {ds.SOPInstanceUID: ds for ds in datasets}
            ordered = [by_sop[sop] for sop in self.sops if sop in by_sop]
            if not ordered:
                raise ValueError("no slices matched the recorded SOPs")
            rebuilt = Read3D(ordered, only_tags=False, register=False)
        except ValueError:
            raise
        except Exception as e:
            # the files changed/corrupted since the only_tags pass: a
            # clean typed error instead of whatever the rebuild hit
            # (fuzz finding)
            raise ValueError(
                f"deferred pixel load failed for {self.image_name!r}: "
                f"{type(e).__name__}: {e}") from e
        self.array = rebuilt.array
        self.window = self.get_window()
        self.display = Display(self)
        return self.array

    # -- grid bundle (replaces create_sitk_image, image.py:906-930) -----
    def create_volume(self, empty=False):
        """Array + geometry bundle (the SimpleITK-image equivalent)."""
        arr = np.zeros([int(d) for d in self.dimensions][::-1],
                       dtype=np.uint8) if empty else np.asarray(self.array)
        return {"array": arr,
                "origin": np.asarray(self.origin, dtype=float),
                "spacing": np.asarray(self.spacing, dtype=float),
                "direction": np.asarray(self.matrix, dtype=float)}

    create_sitk_image = create_volume

    def compute_projection(self, mode="mip", axis="y", angles=None,
                           center=None, mu_water_mm=0.02):
        """2D projection of the volume — BEYOND-PARITY (the reference
        has no projection rendering): ``mip`` (maximum intensity,
        review views), ``mean``, or ``drr`` (parallel-beam digitally
        reconstructed radiograph for RT positioning: attenuation
        mu = mu_water*(1 + HU/1000) clamped at 0, detector signal
        1 - exp(-sum mu dl)). Optional Euler ``angles`` (deg, zyx)
        rotate about ``center`` (defaults to the volume center)
        through the same device resample create_rotated_volume uses.
        ``axis`` is the array axis to integrate: 'z' | 'y' | 'x'.
        Returns a 2D float32 array."""
        import jax.numpy as jnp

        try:
            ax = {"z": 0, "y": 1, "x": 2}[axis]
        except KeyError:
            raise ValueError(f"compute_projection: axis {axis!r} not "
                             "in ('z', 'y', 'x')") from None
        if mode not in ("mip", "mean", "drr"):
            raise ValueError(f"compute_projection: mode {mode!r} not "
                             "in ('mip', 'mean', 'drr')")

        vol = np.asarray(self.array, np.float32)
        if angles is not None and np.any(np.asarray(angles)):
            from ..ops.resample import (affine_resample,
                                        compose_pixel_matrix)
            from ..utils.image.transform import euler_transform

            if center is None:
                center = np.asarray(
                    self.compute_center(), np.float64)
            t = euler_transform(angles=angles, rotation_center=center,
                                zyx=True)
            A = compose_pixel_matrix(
                self.matrix, self.spacing, self.origin, self.matrix,
                self.spacing, self.origin,
                phys_transform=t.as_matrix4())
            # corners rotated in from outside the volume carry the
            # -3001 fill — non-physical (below air) and would bias
            # mean/MIP/DRR; clamp them to air
            vol = np.asarray(affine_resample(
                vol, A, vol.shape,
                background=float(config.background_fill)))
            vol = np.maximum(vol, -1000.0, dtype=np.float32)

        v = jnp.asarray(vol)
        if mode == "mip":
            out = v.max(axis=ax)
        elif mode == "mean":
            out = v.mean(axis=ax)
        else:  # drr
            # step length along the integration axis in mm
            dl = float(self.spacing[{0: 2, 1: 1, 2: 0}[ax]])
            mu = jnp.maximum(mu_water_mm * (1.0 + v / 1000.0), 0.0)
            out = 1.0 - jnp.exp(-mu.sum(axis=ax) * dl)
        return np.asarray(out, np.float32)

    def create_rotated_volume(self, angles=(0, 0, 10), roi_name="Liver",
                              center=None):
        """Euler-rotate the volume about an ROI center and resample onto
    the same grid (generalizes the reference's demo-grade
    create_rotated_sitk_image, structure/image.py:932-959, which
    hardcoded a 10-degree z rotation about rois['Liver'])."""
        from ..ops.resample import affine_resample, compose_pixel_matrix
        from ..utils.image.transform import euler_transform

        if center is None:
            center = self.rois[roi_name].mesh.center
        t = euler_transform(angles=angles, rotation_center=center,
                            zyx=True)
        A = compose_pixel_matrix(self.matrix, self.spacing, self.origin,
                                 self.matrix, self.spacing, self.origin,
                                 phys_transform=t.as_matrix4())
        out = affine_resample(np.asarray(self.array, np.float32), A,
                              self.array.shape, background=0.0)
        return np.asarray(out)

    create_rotated_sitk_image = create_rotated_volume

    # -- persistence (documented schema: npz + json instead of pickle) --
    def save_image(self, path, rois=True, pois=True):
        """Serialize metadata (json) + array (npy) + ROI/POI folders
        (replaces the reference's pickled DataFrame, structure/
        image.py:708-801, with a documented schema)."""
        base = os.path.join(str(path), self.image_name)
        os.makedirs(base, exist_ok=True)
        meta = {
            "image_name": self.image_name, "modality": self.modality,
            "patient_name": self.patient_name, "mrn": self.mrn,
            "birthdate": self.birthdate, "date": str(self.date),
            "time": str(self.time), "series_uid": self.series_uid,
            "acq_number": str(self.acq_number), "frame_ref": self.frame_ref,
            "window": [float(w) for w in self.window], "plane": self.plane,
            "spacing": np.asarray(self.spacing, dtype=float).tolist(),
            "dimensions": np.asarray(self.dimensions).astype(int).tolist(),
            "orientation": np.asarray(self.orientation,
                                      dtype=float).tolist(),
            "origin": np.asarray(self.origin, dtype=float).tolist(),
            "matrix": np.asarray(self.matrix, dtype=float).tolist(),
            "unverified": self.unverified,
            "skipped_slice": list(self.skipped_slice or []),
            "rgb": bool(self.rgb),
            "sops": list(self.sops or []),
            "filepaths": [str(f) for f in (self.filepaths or [])],
        }
        with open(os.path.join(base, "meta.json"), "w") as f:
            json.dump(meta, f, indent=1)
        if self.array is not None:
            np.save(os.path.join(base, "array.npy"), np.asarray(self.array))
        if rois:
            self.save_rois(base)
        if pois:
            self.save_pois(base)

    def save_rois(self, path, create_main_folder=False):
        base = os.path.join(str(path), "rois") if not create_main_folder \
            else os.path.join(str(path), self.image_name, "rois")
        for name, roi in self.rois.items():
            if roi.contour_position is None:
                continue
            folder = os.path.join(base, name)
            os.makedirs(folder, exist_ok=True)
            with open(os.path.join(folder, "roi.json"), "w") as f:
                json.dump({"name": name, "color": list(roi.color or []),
                           "visible": bool(roi.visible),
                           "plane": roi.plane}, f)
            for ii, c in enumerate(roi.contour_position):
                np.save(os.path.join(folder, f"contour_{ii:04d}.npy"),
                        np.asarray(c))

    def save_pois(self, path, create_main_folder=False):
        base = os.path.join(str(path), "pois") if not create_main_folder \
            else os.path.join(str(path), self.image_name, "pois")
        for name, poi in self.pois.items():
            if poi.point_position is None:
                continue
            folder = os.path.join(base, name)
            os.makedirs(folder, exist_ok=True)
            with open(os.path.join(folder, "poi.json"), "w") as f:
                json.dump({"name": name, "color": list(poi.color or []),
                           "visible": bool(poi.visible)}, f)
            np.save(os.path.join(folder, "point.npy"),
                    np.asarray(poi.point_position))

    def load_rois(self, roi_path):
        """Load ROI folders; name collisions get _N suffixes (reference
        structure/image.py:836-869 semantics, pickle replaced)."""
        for entry in sorted(os.listdir(roi_path)):
            folder = os.path.join(roi_path, entry)
            if not os.path.isdir(folder):
                continue
            with open(os.path.join(folder, "roi.json")) as f:
                meta = json.load(f)
            name = meta["name"]
            ii = 1
            while name in self.rois and \
                    self.rois[name].contour_position is not None:
                ii += 1
                name = f"{meta['name']}_{ii}"
            contours = [np.load(os.path.join(folder, f))
                        for f in sorted(os.listdir(folder))
                        if f.startswith("contour_")]
            self.rois[name] = Roi(self, position=contours, name=name,
                                  color=meta.get("color"),
                                  visible=meta.get("visible", False),
                                  filepaths=folder,
                                  plane=meta.get("plane"))
        Data.match_rois()

    def load_pois(self, poi_path):
        """Fixed vs reference: structure/image.py:896 instantiates
        lowercase `poi` (NameError) and :903 writes into self.rois."""
        for entry in sorted(os.listdir(poi_path)):
            folder = os.path.join(poi_path, entry)
            if not os.path.isdir(folder):
                continue
            with open(os.path.join(folder, "poi.json")) as f:
                meta = json.load(f)
            name = meta["name"]
            ii = 1
            while name in self.pois and \
                    self.pois[name].point_position is not None:
                ii += 1
                name = f"{meta['name']}_{ii}"
            point = np.load(os.path.join(folder, "point.npy"))
            self.pois[name] = Poi(self, position=point, name=name,
                                  color=meta.get("color"),
                                  visible=meta.get("visible", False),
                                  filepaths=folder)
        Data.match_pois()

    @classmethod
    def load_image(cls, image_path, rois=True, pois=True):
        """Reconstruct an Image from a save_image folder and register it."""
        from ..utils.creation import image_from_saved
        return image_from_saved(image_path, rois=rois, pois=pois)

    # -- external contour ------------------------------------------------
    def create_external(self, name="External", color=None, visible=False,
                        filepaths=None, threshold=-250):
        """Threshold -> largest component -> contours -> ROI + mesh
        (reference structure/image.py:961-994)."""
        from ..utils.image.threshold import external
        from ..utils.roi.contour import contours_from_mask

        if color is None:
            color = [0, 255, 0]

        if name not in self.rois:
            self.rois[name] = Roi(self, name=name, color=color,
                                  visible=visible, filepaths=filepaths)

        mask = external(self.array, threshold=threshold, only_mask=True)
        contours = contours_from_mask(mask.astype(np.uint8))
        positions = self.rois[name].convert_pixel_to_position(pixel=contours)

        self.rois[name].contour_pixel = contours
        self.rois[name].contour_position = positions
        self.rois[name].create_discrete_mesh()
        return self.rois[name]
