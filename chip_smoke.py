#!/usr/bin/env python
"""Smoke run of the clear-sky radiation path on NVIDIA GPUs.

    python chip_smoke.py               # phases 1-5 on one GPU
    python chip_smoke.py --four-gpus   # phase 6 alone, on four GPUs

Configuration: Cloudless LW+SW with the full RRTMG-IFS spectrum (140 LW
/ 112 SW g-points) at 137 levels (ecrad_tpu/data/cloudless_slice8.nam),
on 8192 columns: the 8 IFS columns of ecrad_tpu/data/ifs_slice_8col.nc
tiled x1024 with seeded perturbations (ecrad_tpu/io/tiling.py), copy 0
unperturbed.

1. Device: JAX's platform, device kind and count; the card's name and
   power limit from nvidia-smi.
2. setup_radiation + jit(radiation) on the 8192 columns: compile
   seconds, steady per-call seconds, peak device bytes.
3. Accuracy: the unperturbed 8 columns against the float64 truth
   tests/goldens/cloudless_slice8_f64.npz (tools/make_slice_golden.py),
   per-field max-abs bounds in W m-2 (F64_BOUNDS).
4. Each hand-written kernel (ops/adding_gpu.py) against its lax.scan
   reference at 137 levels, 140/112 g-points and 8192 columns: relative
   error (<= 1e-5, float32 elementwise arithmetic) and both timings.
5. The CLI driver on the in-repo namelist and slice, writing NetCDF to
   a temporary file; its fluxes must be finite.
6. (--four-gpus, alone) 4 x 8192 columns sharded over a 1-D `columns`
   mesh of 4 GPUs, against one GPU's run of the same columns (rel <=
   1e-5 on every flux field); the compiled step holds no collectives.

Everything runs in this one process. Without a GPU, or when any phase
fails, it exits non-zero and prints no result line. The last line of
stdout is {"ok": true, "device": {"platform": ..., "kind": ...,
"count": ...}}. The compile cache is $JAX_COMPILATION_CACHE_DIR, else
<repo>/.jax_cache.
"""
import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
NCOL = 8192
SEED = 0
REPS = 10
GOLDEN = os.path.join(HERE, "tests", "goldens", "cloudless_slice8_f64.npz")
# Clear-sky float32 vs float64 contract, max abs W m-2 per field
# (tests/test_f64_validation.py holds the cloudy solvers to the same)
F64_BOUNDS = {"lw_up": 0.01, "lw_dn": 0.01, "sw_up": 0.20, "sw_dn": 0.20,
              "sw_dn_direct": 0.02}
KERNEL_REL = 1e-5
SHARD_REL = 1e-5


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def log(*args):
    print(*args, flush=True)


def timed(fn, *args, reps=REPS):
    """(result, per-call seconds of `reps` calls after a warm-up), each
    call ended by block_until_ready."""
    import jax
    out = jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    return out, times


def fmt_times(times):
    return (f"median {np.median(times):.6f} s, min {min(times):.6f} s "
            f"over {len(times)} calls")


def compile_timed(fn, *args):
    """(compiled, seconds to lower and compile)."""
    t0 = time.perf_counter()
    compiled = fn.lower(*args).compile()
    return compiled, time.perf_counter() - t0


# ---------------------------------------------------------------------------

def phase_device(want):
    import jax
    devices = jax.devices()
    dev = devices[0]
    log(f"[1] device: platform {dev.platform}, kind {dev.device_kind}, "
        f"count {len(devices)}")
    check(dev.platform == "gpu", f"no GPU: JAX runs on {dev.platform}")
    check(len(devices) >= want, f"{want} GPUs needed, {len(devices)} seen")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()
    log("[1] card name, power limit (nvidia-smi):")
    for line in smi:
        log(line)
    return devices


def n_gpoints(setup):
    """(LW, SW) g-point counts of the configuration."""
    return (len(setup.spec.band_from_g_lw), len(setup.spec.band_from_g_sw))


def setup_and_batch(ncol=NCOL, seed=SEED):
    from ecrad_tpu.config import load_config_from_namelist
    from ecrad_tpu.interface import setup_radiation
    from ecrad_tpu.io.input_reader import read_input
    from ecrad_tpu.io.tiling import tile_columns
    from ecrad_tpu.paths import CLOUDLESS_NAMELIST, IFS_SLICE
    setup = setup_radiation(load_config_from_namelist(CLOUDLESS_NAMELIST))
    inputs = read_input(IFS_SLICE)
    return setup, tile_columns(inputs, ncol // inputs[0].ncol, seed)


def phase_radiation(dev, setup, batch):
    import jax
    from ecrad_tpu.interface import radiation
    ncol = batch[0].ncol
    nlev = batch[1].pressure_hl.shape[1] - 1
    ng_lw, ng_sw = n_gpoints(setup)
    log(f"[2] Cloudless LW+SW, RRTMG-IFS {ng_lw} LW / {ng_sw} SW "
        f"g-points, {nlev} levels, {ncol} columns")
    batch = jax.device_put(batch, dev)
    step = jax.jit(lambda *a: radiation(setup, *a))
    compiled, compile_s = compile_timed(step, *batch)
    log(f"[2] compile {compile_s:.3f} s")
    flux, times = timed(compiled, *batch)
    log(f"[2] steady per call: {fmt_times(times)} "
        f"({ncol / np.median(times):.1f} columns/s)")
    peak = (dev.memory_stats() or {}).get("peak_bytes_in_use")
    log(f"[2] peak_bytes_in_use {peak}")
    for key in F64_BOUNDS:
        arr = np.asarray(getattr(flux, key))
        check(arr.shape == (ncol, nlev + 1), f"{key} shape {arr.shape}")
        check(np.isfinite(arr).all(), f"{key} not finite")
    return flux


def phase_accuracy(flux):
    golden = np.load(GOLDEN)
    ncol = golden["lw_up"].shape[0]
    failures = []
    for key, bound in F64_BOUNDS.items():
        got = np.asarray(getattr(flux, key), np.float64)[:ncol]
        err = float(np.abs(got - golden[key]).max())
        log(f"[3] {key}: max abs err vs f64 {err:.6f} W m-2 "
            f"(bound {bound})")
        if not err <= bound:
            failures.append(key)
    check(not failures, f"outside the f64 bounds: {failures}")


def kernel_cases(nlev, ng_lw, ng_sw, ncol, seed=SEED):
    """(name, kernel fn, lax.scan fn, args) for each adding kernel, on
    layer properties in physical ranges (R + T < 1)."""
    import jax
    import jax.numpy as jnp
    from ecrad_tpu.ops import adding_gpu as K
    from ecrad_tpu.solvers import adding as A
    keys = iter(jax.random.split(jax.random.PRNGKey(seed), 16))

    def u(shape, lo=0.0, hi=1.0):
        return jax.random.uniform(next(keys), shape, jnp.float32, lo, hi)

    lay_sw, bnd_sw = (nlev, ng_sw, ncol), (ng_sw, ncol)
    lay_lw, bnd_lw = (nlev, ng_lw, ncol), (ng_lw, ncol)
    sw = (u(lay_sw, hi=0.4), u(lay_sw, 0.3, 0.6), u(lay_sw, hi=0.3),
          u(lay_sw, hi=0.4), u(lay_sw, 0.2, 0.9), u(bnd_sw, hi=1300.0),
          u(bnd_sw, hi=0.8), u(bnd_sw, hi=0.8), u((1, ncol), 0.05, 1.0))
    lw = (u(lay_lw, hi=0.4), u(lay_lw, 0.3, 0.6), u(lay_lw, hi=20.0),
          u(lay_lw, hi=20.0), u(bnd_lw, hi=400.0), u(bnd_lw, hi=0.2))
    return [
        ("adding_sw", K.adding_sw,
         lambda *a: A._adding_sw_sequential(*a, gfirst=True), sw),
        ("adding_lw", K.adding_lw,
         lambda *a: A._adding_lw_sequential(*a, gfirst=True), lw),
        ("lw_no_scattering", K.lw_no_scattering,
         lambda *a: A._lw_no_scattering_sequential(*a, gfirst=True),
         lw[1:]),
    ]


def phase_kernels(setup, nlev):
    import jax
    failures = []
    for name, kernel, scan, args in kernel_cases(
            nlev, *n_gpoints(setup), NCOL):
        ck, ck_s = compile_timed(jax.jit(kernel), *args)
        cs, cs_s = compile_timed(jax.jit(scan), *args)
        out_k, t_k = timed(ck, *args)
        out_s, t_s = timed(cs, *args)
        rel = max(float(np.abs(np.asarray(k) - np.asarray(s)).max()
                        / max(float(np.abs(np.asarray(s)).max()), 1e-30))
                  for k, s in zip(out_k, out_s))
        shape = tuple(args[0].shape)
        log(f"[4] {name} {shape}: rel err vs lax.scan {rel:.3e} "
            f"(bound {KERNEL_REL})")
        log(f"[4] {name} kernel: compile {ck_s:.3f} s, {fmt_times(t_k)}")
        log(f"[4] {name} lax.scan: compile {cs_s:.3f} s, {fmt_times(t_s)}")
        if not rel <= KERNEL_REL:
            failures.append(name)
        del out_k, out_s, args
    check(not failures, f"kernels off their reference: {failures}")


def phase_cli():
    from scipy.io import netcdf_file
    from ecrad_tpu.driver import main
    from ecrad_tpu.paths import CLOUDLESS_NAMELIST, IFS_SLICE
    with tempfile.TemporaryDirectory() as tmp:
        out = os.path.join(tmp, "fluxes.nc")
        t0 = time.perf_counter()
        rc = main([CLOUDLESS_NAMELIST, IFS_SLICE, out])
        log(f"[5] CLI rc {rc} in {time.perf_counter() - t0:.3f} s")
        check(rc == 0, f"CLI exit code {rc}")
        with netcdf_file(out, "r", mmap=False) as f:
            for name in ("flux_up_lw", "flux_dn_lw", "flux_up_sw",
                         "flux_dn_sw", "flux_dn_direct_sw"):
                arr = np.asarray(f.variables[name][:])
                check(arr.shape == (8, 138) and np.isfinite(arr).all(),
                      f"CLI {name}: shape {arr.shape} or not finite")
    log("[5] CLI output finite, 8 columns x 138 half levels")


def phase_four_gpus(devices):
    import jax
    from ecrad_tpu.interface import radiation
    from ecrad_tpu.parallel.sharding import (column_mesh, column_parallel,
                                             count_collectives,
                                             shard_columns)
    devices = devices[:4]
    setup, batch = setup_and_batch(4 * NCOL)
    mesh = column_mesh(devices)
    step = column_parallel(lambda *a: radiation(setup, *a), mesh)
    args = shard_columns(batch, mesh)
    compiled, compile_s = compile_timed(step, *args)
    collectives = count_collectives(compiled.as_text())
    log(f"[6] {4 * NCOL} columns over a 4-GPU `columns` mesh: compile "
        f"{compile_s:.3f} s, collectives in the step: {collectives or 0}")
    check(not collectives, f"collectives in the step: {collectives}")
    flux4, times = timed(compiled, *args)
    log(f"[6] 4 GPUs steady per call: {fmt_times(times)} "
        f"({4 * NCOL / np.median(times):.1f} columns/s)")
    # the same columns on one GPU, a quarter at a time
    one = jax.jit(lambda *a: radiation(setup, *a))
    quarters = []
    for q in range(4):
        part = jax.tree.map(
            lambda x: (x[q * NCOL:(q + 1) * NCOL]
                       if np.ndim(x) > 0 else x), batch)
        quarters.append(jax.device_get(one(*jax.device_put(part,
                                                           devices[0]))))
    worst = 0.0
    failures = []
    paths = jax.tree_util.tree_flatten_with_path(flux4)[0]
    singles = zip(*(jax.tree.leaves(q) for q in quarters))
    for (path, a), parts in zip(paths, singles):
        key = jax.tree_util.keystr(path)
        a, b = np.asarray(a), np.concatenate(parts, axis=0)
        check(a.shape == b.shape, f"{key}: {a.shape} vs {b.shape}")
        rel = float(np.abs(a - b).max() / max(np.abs(b).max(), 1.0))
        worst = max(worst, rel)
        if not rel <= SHARD_REL:
            failures.append(f"{key}: {rel:.2e}")
    log(f"[6] sharded vs one GPU, every flux field: worst rel {worst:.3e} "
        f"(bound {SHARD_REL})")
    check(not failures, f"shard-dependent fields: {failures}")


# ---------------------------------------------------------------------------

def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-gpus", action="store_true",
                    help="run the four-GPU column-sharding phase alone")
    args = ap.parse_args(argv)
    want = 4 if args.four_gpus else 1

    from ecrad_tpu.paths import enable_compile_cache
    log(f"compile cache: {enable_compile_cache()}")
    try:
        devices = phase_device(want)
        dev = devices[0]
        if args.four_gpus:
            phase_four_gpus(devices)
        else:
            setup, batch = setup_and_batch()
            flux = phase_radiation(dev, setup, batch)
            phase_accuracy(flux)
            del flux
            phase_kernels(setup, batch[1].pressure_hl.shape[1] - 1)
            phase_cli()
    except (PhaseError, subprocess.SubprocessError, OSError) as e:
        print(f"chip_smoke FAILED: {e}", file=sys.stderr, flush=True)
        return 1
    print(json.dumps({"ok": True, "device": {
        "platform": dev.platform, "kind": dev.device_kind,
        "count": len(devices)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
