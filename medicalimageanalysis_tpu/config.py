"""Central numeric-policy configuration.

The reference hard-codes these constants inline (see SURVEY.md §5 "Config /
flag system"); here they are collected into one dataclass with identical
defaults so behavior parity is auditable:

- background fill -3001: reference structure/image.py:195, rigid.py:737,
  deformable.py:761
- external threshold -250 HU: reference structure/image.py:961
- orientation rounding 3 dp: reference read/dicom.py:263
- spacing tolerance 0.01 mm: reference read/dicom.py:609
- mesh decimation target 50k pts: reference read/mf3.py:215
- ModelToMask pad 5 voxels: reference utils/convert/contour.py:395-408
- ICP landmark cap N/10: reference utils/rigid/icp.py:79-80
- B-spline control spacing 50 mm: reference utils/deformable/simpleitk.py:106-107
"""

from dataclasses import dataclass


@dataclass
class MiaConfig:
    background_fill: float = -3001.0
    external_threshold: float = -250.0
    orientation_decimals: int = 3
    contour_decimals: int = 3
    spacing_tolerance_mm: float = 0.01
    mesh_decimate_target_points: int = 50_000
    model_to_mask_pad_voxels: int = 5
    icp_landmark_divisor: int = 10
    bspline_control_spacing_mm: float = 50.0
    # device execution knobs (new; no reference counterpart)
    device_dtype: str = "float32"
    jit_ingest: bool = True
    default_mesh_axes: tuple = ("data", "space")


config = MiaConfig()
