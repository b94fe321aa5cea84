"""Time the trilinear warp family on the accelerator against its HBM
roofline.

Cases (all float32):
  affine   affine reslice at 256^3 (the XLA fusion behind affine_resample)
  disp     displacement warp at 128x256x256 (ops.warp.warp_disp)
  vjp      one value+VJP step of ops.warp.make_warp_sampler at 128x256x256
  e2e      affine_resample end to end at 256^3 (host volume in, host
           volume out)
  copy     a 1 GiB elementwise pass: the bandwidth this card reaches

The roofline counts the minimal traffic: the volume read once, plus the
coordinate or field inputs and every output, at the card's published
HBM rate. Prints one JSON object per case and needs an accelerator.

Run:  python scripts/measure_warp.py
"""

from __future__ import annotations

import functools
import json
import os
import subprocess
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

# published HBM rate of the card, by device_kind (NVIDIA data sheets)
HBM_BYTES_PER_S = {"NVIDIA H100 80GB HBM3": 3.35e12}

def _time(fn, *args, reps=20):
    jax.block_until_ready(fn(*args))
    jax.block_until_ready(fn(*args))
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _rot(deg_z, deg_x, shape, shift):
    """Pixel matrix of a rotation about the volume centre + shift."""
    tz, tx = np.deg2rad(deg_z), np.deg2rad(deg_x)
    Rz = np.array([[np.cos(tz), -np.sin(tz), 0], [np.sin(tz), np.cos(tz), 0],
                   [0, 0, 1]])
    Rx = np.array([[1, 0, 0], [0, np.cos(tx), -np.sin(tx)],
                   [0, np.sin(tx), np.cos(tx)]])
    R = Rz @ Rx
    c = np.array([shape[2], shape[1], shape[0]], np.float64) / 2 - 0.5
    A = np.eye(4)
    A[:3, :3] = R
    A[:3, 3] = c - R @ c + np.asarray(shift)
    return A.astype(np.float32)


def main():
    dev = jax.devices()[0]
    if dev.platform == "cpu":
        print("measure_warp: no accelerator found", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True)
    print(smi.stdout.strip())
    peak = HBM_BYTES_PER_S[dev.device_kind]
    from medicalimageanalysis_tpu.ops import warp as pw
    from medicalimageanalysis_tpu.ops.resample import (
        _affine_resample_jit, affine_resample)

    rng = np.random.default_rng(0)

    def report(case, shape, seconds, nbytes, **extra):
        pts = int(np.prod(shape))
        floor = nbytes / peak
        row = {"case": case, "shape": list(shape), "ms": seconds * 1e3,
               "pts_per_s": pts / seconds, "min_bytes": nbytes,
               "roofline_share": floor / seconds, **extra,
               "device": dev.device_kind}
        print(json.dumps(row), flush=True)

    # 1. affine reslice at 256^3
    n = 256
    vol = jnp.asarray(rng.standard_normal((n, n, n)).astype(np.float32))
    A = jnp.asarray(_rot(7.0, 4.0, (n, n, n), (1.3, -2.1, 0.7)))
    bg = jnp.float32(-3001.0)
    aff = jax.jit(functools.partial(_affine_resample_jit,
                                    out_shape=(n, n, n)))
    t_aff = _time(lambda v, a: aff(v, a, background=bg), vol, A)
    report("affine", (n, n, n), t_aff, 2 * n ** 3 * 4)

    # 2. displacement warp at 128x256x256
    shp = (128, 256, 256)
    vol2 = jnp.asarray(rng.standard_normal(shp).astype(np.float32))
    zz, yy, xx = np.meshgrid(*[np.arange(s, dtype=np.float32) for s in shp],
                             indexing="ij")
    disp = np.stack([2.5 * np.sin(zz / 17.0), 1.5 * np.cos(xx / 23.0),
                     1.2 * np.sin(yy / 31.0)]).astype(np.float32)
    disp = jnp.asarray(disp)
    dw = jax.jit(lambda v, d: pw.warp_disp(v, d, 0.0))
    t_disp = _time(dw, vol2, disp)
    N = int(np.prod(shp))
    report("disp", shp, t_disp, N * 4 + 3 * N * 4 + N * 4)

    # 3. one value+VJP step of make_warp_sampler
    base = jnp.asarray(np.stack([zz, yy, xx]))

    def vjp_step(v, c):
        sampler = pw.make_warp_sampler(v, 0.0)
        return jax.value_and_grad(
            lambda cc: jnp.sum(sampler(cc[0], cc[1], cc[2]) ** 2))(c)

    coords = base + disp[::-1]
    t_vjp = _time(jax.jit(vjp_step), vol2, coords)
    report("vjp", shp, t_vjp, N * 4 + 3 * N * 4 + 3 * N * 4)

    # 4. end to end: host volume in, host volume out
    vol_h, A_h = np.asarray(vol), np.asarray(A)

    def e2e():
        return np.asarray(affine_resample(vol_h, A_h, (n, n, n), -3001.0))

    e2e()
    ts = []
    for _ in range(10):
        t0 = time.perf_counter()
        e2e()
        ts.append(time.perf_counter() - t0)
    print(json.dumps({"case": "e2e", "shape": [n, n, n],
                      "ms_median": float(np.median(ts)) * 1e3,
                      "ms_all": [t * 1e3 for t in ts],
                      "device": dev.device_kind}), flush=True)

    # large copy: the practical bandwidth ceiling on this card
    big = jnp.ones((1 << 28,), jnp.float32)
    cp = jax.jit(lambda x: x * 1.0001)
    t_cp = _time(cp, big)
    print(json.dumps({"case": "copy", "bytes": 2 * big.nbytes,
                      "bytes_per_s": 2 * big.nbytes / t_cp,
                      "device": dev.device_kind}), flush=True)


if __name__ == "__main__":
    main()
