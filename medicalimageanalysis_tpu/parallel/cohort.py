"""Cohort-scale ingest: whole-patient batches through one device program.

The production entry point for the BASELINE north-star workload: parse
and assemble a cohort on host, then run rescale + resample + Gaussian +
external-mask for ALL series in a single (optionally Mesh-sharded)
XLA program — no per-series host<->device round trips.
"""

from __future__ import annotations

import numpy as np

import jax

from ..config import config
from ..data import Data
from ..telemetry import trace

__all__ = ["ingest_cohort", "distributed_cohort_batch"]


def distributed_cohort_batch(local_volumes, mesh):
    """Form a GLOBAL (B_total, Z, Y, X) device array over the mesh's
    'data' axis from this process's local stack — the multi-host cohort
    ingest pattern (SURVEY §2.11): every host parses and assembles its
    own files; only device shards exist globally, and nothing crosses
    hosts until a collective asks for it.

    local_volumes : list/stack of this process's (Z, Y, X) arrays; all
        processes must contribute the same count and shape.
    Returns a jax global array sharded (data, space) like
    :func:`mesh.volume_sharding`.
    """
    from .mesh import volume_sharding

    local = np.stack([np.asarray(v) for v in local_volumes])
    b_total = local.shape[0] * jax.process_count()
    sharding = volume_sharding(mesh)
    return jax.make_array_from_process_local_data(
        sharding, local, (b_total,) + local.shape[1:])


def ingest_cohort(folder_path=None, file_list=None, out_shape=None,
                  threshold=-250.0, sigma_vox=1.0, mesh=None, clear=True,
                  keep_host_arrays=True):
    """read_dicoms + batched device preprocessing for a cohort.

    Returns dict: image_name -> {"volume": jax (oz, oy, ox) f32,
    "mask": jax uint8} (device-resident; stack stays in HBM for
    downstream registration). Series are grouped by raw shape so each
    distinct shape compiles once.
    """
    from .. import reader
    from .batch import make_preprocess_fn
    from .mesh import batch_sharding, volume_sharding

    prev = config.jit_ingest
    config.jit_ingest = False  # host assembles; device work is batched
    try:
        with trace("mia.cohort.ingest"):
            dicom_reader = reader.read_dicoms(
                folder_path=folder_path, file_list=file_list, clear=clear)
    finally:
        config.jit_ingest = prev

    names = list(dicom_reader.report.images_created or Data.image_list)
    names = [n for n in names
             if Data.image[n].array is not None
             and Data.image[n].array.ndim == 3]

    by_shape = {}
    for n in names:
        by_shape.setdefault(Data.image[n].array.shape, []).append(n)

    results = {}
    for shape, group in by_shape.items():
        out = tuple(out_shape) if out_shape is not None else shape
        fn = make_preprocess_fn(shape, out, ffs_op="none",
                                threshold=threshold, sigma_vox=sigma_vox)
        if mesh is not None:
            jfn = jax.jit(fn, in_shardings=(volume_sharding(mesh),
                                            batch_sharding(mesh),
                                            batch_sharding(mesh)),
                          out_shardings=(volume_sharding(mesh),
                                         volume_sharding(mesh)))
        else:
            jfn = jax.jit(fn)

        batch = np.stack([Data.image[n].array for n in group])
        slopes = np.ones(len(group), np.float32)
        intercepts = np.zeros(len(group), np.float32)
        with trace("mia.cohort.device"):
            vols, masks = jfn(batch, slopes, intercepts)
        for i, n in enumerate(group):
            results[n] = {"volume": vols[i], "mask": masks[i]}
            if not keep_host_arrays:
                Data.image[n].array = None
    return results
