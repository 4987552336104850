#!/usr/bin/env python
"""Benchmark: columns per second of clear-sky LW+SW radiation at 137
levels on a GPU.

    python bench.py [--columns 8192] [--repeat 10]

The inputs are the 8 IFS columns of ecrad_tpu/data/ifs_slice_8col.nc
tiled to --columns with seeded perturbations (ecrad_tpu/io/tiling.py);
the configuration is ecrad_tpu/data/cloudless_slice8.nam (Cloudless LW
and SW, full RRTMG-IFS spectrum).

Prints one JSON line: steady-state columns/s (median of
--repeat calls, each ended by block_until_ready), compile seconds and
peak device bytes, with the device as JAX reports it and the card's
name and power limit. Refuses to run without a GPU. The compile cache
is $JAX_COMPILATION_CACHE_DIR, else <repo>/.jax_cache.
"""
import argparse
import json
import subprocess
import sys
import time

import numpy as np


def card_name_and_power_limit() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


def bench_cloudless(ncol, repeat, seed=0):
    import jax
    from ecrad_tpu.config import load_config_from_namelist
    from ecrad_tpu.interface import radiation, setup_radiation
    from ecrad_tpu.io.input_reader import read_input
    from ecrad_tpu.io.tiling import tile_columns
    from ecrad_tpu.paths import CLOUDLESS_NAMELIST, IFS_SLICE

    setup = setup_radiation(load_config_from_namelist(CLOUDLESS_NAMELIST))
    inputs = read_input(IFS_SLICE)
    dev = jax.devices()[0]
    batch = jax.device_put(
        tile_columns(inputs, ncol // inputs[0].ncol, seed), dev)
    ncol = batch[0].ncol

    step = jax.jit(lambda *a: radiation(setup, *a))
    t0 = time.perf_counter()
    compiled = step.lower(*batch).compile()
    compile_s = time.perf_counter() - t0
    jax.block_until_ready(compiled(*batch))
    times = []
    for _ in range(repeat):
        t0 = time.perf_counter()
        jax.block_until_ready(compiled(*batch))
        times.append(time.perf_counter() - t0)
    per_call = float(np.median(times))
    return {
        "metric": "cloudless_columns_per_sec",
        "value": ncol / per_call,
        "unit": "columns/s",
        "columns": ncol,
        "per_call_s": per_call,
        "per_call_s_all": times,
        "compile_s": compile_s,
        "peak_bytes_in_use": (dev.memory_stats() or {}).get(
            "peak_bytes_in_use"),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--columns", type=int, default=8192)
    ap.add_argument("--repeat", type=int, default=10)
    args = ap.parse_args(argv)

    import jax
    from ecrad_tpu.paths import enable_compile_cache
    enable_compile_cache()
    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"bench.py needs a GPU; JAX runs on {devices[0].platform}",
              file=sys.stderr)
        return 1
    device = {"platform": devices[0].platform,
              "kind": devices[0].device_kind, "count": len(devices)}
    card = card_name_and_power_limit()
    line = bench_cloudless(args.columns, args.repeat)
    line.update(device=device, card=card)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
