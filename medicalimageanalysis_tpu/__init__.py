"""medicalimageanalysis_tpu — medical-volume framework on JAX.

A from-scratch JAX/XLA rebuild of the capabilities of
caleb-oconnor/MedicalImageAnalysis (see SURVEY.md). Public API mirrors the
reference package (reference medicalimageanalysis/__init__.py:1-10):

    import medicalimageanalysis_tpu as mia
    mia.read_dicoms(folder_path=...)
    mia.Data.image_list
"""

__version__ = "0.1.0"

from .data import Data

__all__ = ["Data", "__version__"]


def __getattr__(name):
    # Lazy exports keep `import medicalimageanalysis_tpu` light (no jax
    # import until a compute path is touched).
    if name in ("read_dicoms", "read_3mf", "read_mhd", "read_stl",
                "read_vtk", "read_ply", "read_obj", "file_parser",
                "check_memory"):
        from . import reader
        return getattr(reader, name)
    if name == "read_nifti":
        from .read.nifti import read_nifti
        return read_nifti
    if name == "DicomReader":
        from .read.dicom import DicomReader
        return DicomReader
    if name == "MhdReader":
        from .read.mhd import MhdReader
        return MhdReader
    if name == "ThreeMfReader":
        from .read.mf3 import ThreeMfReader
        return ThreeMfReader
    if name in ("StlReader", "VtkReader", "PlyReader", "ObjReader"):
        from . import read
        return getattr(read, name)
    if name == "Image":
        from .structure.image import Image
        return Image
    if name == "Dose":
        from .structure.dose import Dose
        return Dose
    if name == "Rigid":
        from .structure.rigid import Rigid
        return Rigid
    if name == "Deformable":
        from .structure.deformable import Deformable
        return Deformable
    if name == "utils":
        # NOT `from . import utils`: that re-enters __getattr__('utils')
        # through importlib's _handle_fromlist before the submodule
        # import starts -> infinite recursion
        import importlib
        return importlib.import_module(".utils", __name__)
    if name in ("native", "ops", "parallel", "structure", "read", "dicom",
                "models", "config", "reader", "runtime", "telemetry"):
        import importlib
        return importlib.import_module(f".{name}", __name__)
    if name.startswith("_"):
        # never route dunder probes through the utils import below: a
        # probe raised DURING that import re-enters __getattr__ and
        # recursed to death (found via tests/test_native_hostile.py)
        raise AttributeError(
            f"module {__name__!r} has no attribute {name!r}")
    # the reference re-exports utils at top level
    # (reference medicalimageanalysis/__init__.py:6 `from .utils import *`)
    import importlib
    utils = importlib.import_module(".utils", __name__)
    if name in utils.__all__:
        return getattr(utils, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
