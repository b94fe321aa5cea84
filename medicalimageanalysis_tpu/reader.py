"""Top-level IO orchestration: file parsing and reader entry points.

Mirrors the reference API surface (reference reader.py:54-459):
``check_memory``, ``file_parser``, ``read_dicoms``, ``read_3mf``,
``read_mhd``.
"""

from __future__ import annotations

import os
from pathlib import Path

__all__ = ["check_memory", "file_parser", "read_dicoms", "read_3mf",
           "read_mhd", "read_stl", "read_vtk", "read_ply", "read_obj",
           "read_nifti"]


def check_memory(files):
    """Remaining system memory (GB) after hypothetically loading `files`
    (reference reader.py:54-108)."""
    total_size = sum(
        Path(file).stat().st_size
        for file_list in files.values()
        for file in file_list
    )
    return (_available_memory_bytes() - total_size) / 1e9


def _available_memory_bytes():
    """MemAvailable from /proc/meminfo (Linux); elsewhere the free
    physical pages from sysconf."""
    try:
        with open("/proc/meminfo") as f:
            for line in f:
                if line.startswith("MemAvailable:"):
                    return int(line.split()[1]) * 1024
    except OSError:
        pass
    return os.sysconf("SC_AVPHYS_PAGES") * os.sysconf("SC_PAGE_SIZE")


def file_parser(folder_path=None, file_list=None, exclude_files=None):
    """Recursive extension bucketing (reference reader.py:111-227).

    Returns dict with keys Dicom/MHD/Raw/Nifti/Stl/Vtk/3mf/NoExtension.
    ``file_list`` overrides ``folder_path``; ``exclude_files`` honored.
    """
    files = {
        "Dicom": [],
        "MHD": [],
        "Raw": [],
        "Nifti": [],
        "Stl": [],
        "Vtk": [],
        "Ply": [],
        "Obj": [],
        "3mf": [],
        "Zip": [],
        "NoExtension": [],
    }

    exclude_files = exclude_files or []

    if file_list is None:
        file_list = []
        for root, _, filenames in os.walk(folder_path):
            file_list.extend(str(Path(root) / fn) for fn in filenames)

    for filepath in file_list:
        if filepath in exclude_files:
            continue
        extension = Path(filepath).suffix.lower()
        if extension == ".dcm":
            files["Dicom"].append(filepath)
        elif extension == ".mhd":
            files["MHD"].append(filepath)
        elif extension == ".raw":
            files["Raw"].append(filepath)
        elif filepath.lower().endswith(".nii.gz"):
            files["Nifti"].append(filepath)
        elif extension == ".stl":
            files["Stl"].append(filepath)
        elif extension == ".vtk":
            files["Vtk"].append(filepath)
        elif extension == ".ply":
            files["Ply"].append(filepath)
        elif extension == ".obj":
            files["Obj"].append(filepath)
        elif extension == ".3mf":
            files["3mf"].append(filepath)
        elif extension == ".zip":
            files["Zip"].append(filepath)
        elif extension == "":
            files["NoExtension"].append(filepath)

    return files


_ZIP_CACHE = {}


def _expand_zip(path):
    """Extract a .zip archive into a temp dir and return it (zip-slip
    members — absolute or '..' paths — skipped). Extractions are
    cached per (path, mtime, size) so repeated read_dicoms calls on
    the same archive reuse one copy, and all of them are removed at
    interpreter exit. BEYOND-PARITY: clinical archives commonly ship
    zipped; the reference requires pre-extraction."""
    import atexit
    import shutil
    import tempfile
    import zipfile

    st = os.stat(str(path))
    key = (os.path.abspath(str(path)), st.st_mtime_ns, st.st_size)
    cached = _ZIP_CACHE.get(key)
    if cached is not None and os.path.isdir(cached):
        return cached

    out = tempfile.mkdtemp(prefix="mia_zip_")
    if not _ZIP_CACHE:
        atexit.register(
            lambda: [shutil.rmtree(d, ignore_errors=True)
                     for d in _ZIP_CACHE.values()])
    with zipfile.ZipFile(str(path)) as z:
        for m in z.namelist():
            p = Path(m)
            if p.is_absolute() or ".." in p.parts:
                continue
            z.extract(m, out)
    _ZIP_CACHE[key] = out
    return out


def read_dicoms(folder_path=None, file_list=None, exclude_files=None,
                only_tags=False, only_modality=None,
                only_load_roi_names=None, clear=True,
                include_no_extension=True):
    """Load DICOM files into the global Data registry
    (reference reader.py:230-329).

    ``include_no_extension`` (default True) sniffs extension-less
    files for the DICM magic and ingests the matches (the reference
    buckets them but silently ignores them; common in clinical
    archives — the sniff reads 132 bytes per candidate, so it is the
    default). ``folder_path`` may also be a .zip archive (extracted
    to a temp dir), .zip entries in ``file_list`` are expanded, and
    .zip archives FOUND inside a walked folder are expanded in place
    (corrupt archives are skipped; tolerant-ingest semantics)."""
    from .read.dicom import DicomReader

    if only_modality is None:
        # NM/MG/XA are BEYOND-PARITY: the reference's list stops at
        # CT/MR/PT/US/DX/RF/CR (+RT objects, reference reader.py:230-238)
        only_modality = ["CT", "MR", "PT", "NM", "US", "DX", "RF", "CR",
                         "MG", "XA", "SEG", "RTSTRUCT", "REG", "RTDOSE",
                         "RTPLAN"]

    if folder_path is not None \
            and str(folder_path).lower().endswith(".zip") \
            and os.path.isfile(str(folder_path)):
        folder_path = _expand_zip(folder_path)
    if file_list is not None:
        expanded = []
        for f in file_list:
            if str(f).lower().endswith(".zip") \
                    and os.path.isfile(str(f)):
                root = _expand_zip(f)
                for r, _, names in os.walk(root):
                    expanded.extend(str(Path(r) / n) for n in names)
            else:
                expanded.append(f)
        file_list = expanded

    files = None
    if folder_path is not None or file_list is not None:
        files = file_parser(folder_path=folder_path, file_list=file_list,
                            exclude_files=exclude_files)
        for zpath in files.get("Zip", ()):
            try:
                zroot = _expand_zip(zpath)
            except Exception:
                continue  # corrupt archive: skip, like unparseable files
            sub = file_parser(folder_path=zroot)
            for key, vals in sub.items():
                if key != "Zip":  # no nested-zip recursion
                    files[key].extend(vals)
        if include_no_extension:
            for path in files["NoExtension"]:
                try:
                    with open(path, "rb") as f:
                        f.seek(128)
                        if f.read(4) == b"DICM":
                            files["Dicom"].append(path)
                except OSError:
                    pass

    dicom_reader = DicomReader(files, only_tags, only_modality,
                               only_load_roi_names, clear)
    dicom_reader.load()
    return dicom_reader


def read_3mf(file, roi_name=None):
    """Load a 3MF mesh file (reference reader.py:332-372)."""
    from .read.mf3 import ThreeMfReader

    reader = ThreeMfReader(file, roi_name)
    reader.load()
    return reader


def read_stl(file_list):
    """Load STL meshes -> list of TriMesh (functional here; the
    reference's wrapper is commented out at reader.py:462-473)."""
    from .read.stl import read_stl as _read

    if isinstance(file_list, (str, bytes)):
        file_list = [file_list]
    return [_read(f) for f in file_list]


def read_vtk(file_list):
    """Load legacy .vtk polydata -> list of TriMesh (functional here;
    dormant in the reference)."""
    from .read.vtk import read_vtk_polydata

    if isinstance(file_list, (str, bytes)):
        file_list = [file_list]
    return [read_vtk_polydata(f) for f in file_list]


def read_ply(file_list):
    """Load .ply meshes -> list of TriMesh (the reference's generic
    pv.read path would cover these but is dormant; functional here)."""
    from .read.ply import read_ply as _read

    if isinstance(file_list, (str, bytes)):
        file_list = [file_list]
    return [_read(f) for f in file_list]


def read_obj(file_list):
    """Load Wavefront .obj meshes -> list of TriMesh (dormant pv.read
    path in the reference; functional here)."""
    from .read.obj import read_obj as _read

    if isinstance(file_list, (str, bytes)):
        file_list = [file_list]
    return [_read(f) for f in file_list]


def read_nifti(file, modality=None, image_name=None):
    """Load a NIfTI volume (NEW capability; see read/nifti.py)."""
    from .read.nifti import read_nifti as _read
    return _read(file, modality=modality, image_name=image_name)


def read_mhd(file=None, modality=None, image_name=None, roi_name=None,
             roi_names=None, dose=None, dose_name=None,
             reference_name=None, moving_name=None, dvf=False):
    """Load a MetaImage (.mhd) file (reference reader.py:375-459).

    Unlike the reference — whose roi/dose branches are reserved `pass`
    stubs (read/mhd.py:148-152) — `roi_name`/`roi_names` attaches the
    volume as ROI mask(s) on `reference_name`'s image, and `dose`
    (True or a Gy scaling factor) registers it as a Dose grid."""
    from .read.mhd import MhdReader

    reader = MhdReader(file=file, modality=modality,
                       image_name=image_name, roi_name=roi_name,
                       roi_names=roi_names, dose=dose,
                       dose_name=dose_name,
                       reference_name=reference_name,
                       moving_name=moving_name, dvf=dvf)
    reader.load()
    return reader
