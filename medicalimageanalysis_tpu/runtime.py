"""JAX runtime defaults applied once, lazily, by the compute packages.

Persistent compilation cache: a compile cache directory already
configured (``JAX_COMPILATION_CACHE_DIR``, which JAX reads itself, or
``jax.config``) is used as it is. Otherwise the cache lives at the fixed
path ``<checkout>/.jax_cache``: the path is part of the cache key, so a
directory that moves never hits.
"""

from __future__ import annotations

import os

_done = False

DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    ".jax_cache")


def setup_jax_cache():
    """Idempotent: set the persistent compile cache unless one is
    configured already."""
    global _done
    if _done:
        return
    _done = True
    import jax
    if jax.config.jax_compilation_cache_dir is None:
        jax.config.update("jax_compilation_cache_dir", DEFAULT_CACHE_DIR)


_transfer_rate = None


def transfer_rate_bytes_per_s(force=False):
    """One-time measured device<->host transfer bandwidth (bytes/s).

    Host-vs-device auto-selection (marching cubes, voxelization, N4
    finalize) prices the mask or volume download with it. Measures a 4 MB round trip once per process and persists the
    figure next to the compile cache so later processes skip even
    that. Returns None when no device backend is usable.
    """
    global _transfer_rate
    if _transfer_rate is not None and not force:
        return _transfer_rate
    import json
    import time

    try:
        import jax
        import numpy as np
        backend = jax.default_backend()
    except Exception:
        return None
    cache_dir = None
    try:
        cache_dir = getattr(jax.config, "jax_compilation_cache_dir", None)
    except Exception:
        pass
    key = f"{backend}-{len(jax.devices())}"
    path = os.path.join(cache_dir, "transfer_rate.json") \
        if cache_dir else None
    if path and not force:
        try:
            with open(path) as f:
                data = json.load(f)
            if key in data:
                _transfer_rate = float(data[key])
                return _transfer_rate
        except Exception:
            pass
    try:
        n = 1 << 22                       # 4 MB
        # random payload: an all-zeros probe is trivially compressible
        # and a compressing transport would report a rate real pixel
        # data never reaches (review finding)
        host = np.random.default_rng(0).integers(
            0, 256, n, dtype=np.uint8)
        dev = jax.device_put(host)
        np.asarray(dev)                   # warm the path
        t0 = time.perf_counter()
        dev = jax.device_put(host)
        np.asarray(dev)                   # up + down
        dt = max(time.perf_counter() - t0, 1e-6)
        _transfer_rate = 2 * n / dt
    except Exception:
        return None
    if path:
        try:
            data = {}
            if os.path.exists(path):
                with open(path) as f:
                    data = json.load(f)
            data[key] = _transfer_rate
            with open(path, "w") as f:
                json.dump(data, f)
        except Exception:
            pass
    return _transfer_rate
