"""Benchmark: baseband->power throughput on one GPU.

Prints ONE JSON line: {"metric", "value", "unit", "vs_baseline", "device",
...}, where ``device`` names the platform, device kind and device count the
numbers were taken on.

Metric: aggregate complex baseband samples/s through the device step of
real-geometry blocks (8192 frames x 48 chunks x 336 channels x 2 pols =
704,643,072 complex samples = 2.8 GB per block), steady-state streaming
(chained dispatches, then ``block_until_ready`` on the last output).

Baseline: the reference pipeline's hard real-time requirement of
796.4 Msamp/s per node (BASELINE.md — the reference publishes no measured
figures, so real-time is the bar it must clear; vs_baseline = value /
796.4e6 = how many real-time BMF streams one device sustains).

Blocks are generated directly on device in the production layout, so the
step is timed without the host->device copy; ``--h2d`` and ``--e2e``
measure the ingest path separately.

Only a GPU run measures anything: without one the benchmark exits with an
error. ``--quick`` is the exception, a reduced-size smoke run on whatever
backend is present (its output names that platform).
"""

import argparse
import collections
import json
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp

from paf_baseband2power_tpu import constants as C
from paf_baseband2power_tpu.runtime import setup_compile_cache
from paf_baseband2power_tpu.runtime.pipeline import MODES, make_step

BASELINE_SAMPLES_PER_SEC = 796.4e6  # 336 chan * 2 pol * 1.185185 Msamp/s

def device_info() -> dict:
    d = jax.devices()[0]
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(jax.devices())}


def make_block(ndf: int, layout: str, seed: int = 0) -> jax.Array:
    """A random int16 block in the layout's device form: wire
    ``(ndf, nchk*3584)`` or rows ``(nchk*14, ndf, 256)``."""
    if layout == "rows":
        shape = (C.NCHK_NIC * C.NCHAN_CHK * C.NPOL_SAMP, ndf,
                 2 * C.NSAMP_DF)
    else:
        shape = (ndf, C.NCHK_NIC * C.LANES_PER_CHUNK)
    gen = jax.jit(lambda k: jax.random.randint(k, shape, -256, 256,
                                               dtype=jnp.int16))
    return gen(jax.random.key(seed)).block_until_ready()


def stream_fn(kw: dict):
    """``block -> out`` for a mode, threading the carry of stateful
    (fine-channel) steps between calls like the pipeline does."""
    step = make_step(**kw)
    if not kw.get("nfft"):
        return step
    carry = {}

    def run(block):
        out, carry["h"] = step(block, carry.get("h"))
        return out

    return run


def time_step(fn, block, iters: int) -> float:
    """Steady-state seconds per block: warm up (compiling the no-history
    and with-history programs of stateful steps), then the best of three
    chained runs of ``iters`` blocks, each ended by ``block_until_ready``."""
    fn(block).block_until_ready()
    fn(block).block_until_ready()
    best = float("inf")
    for _ in range(3):
        t0 = time.perf_counter()
        out = None
        for _ in range(iters):
            out = fn(block)
        out.block_until_ready()
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


def bench_h2d(ndf: int, iters: int) -> dict:
    """Measure device_put of a full host block (the reference's 2.8 GB
    H2D stage per integration, SURVEY.md section 3.2). The bar is the
    capture-side line rate: 3.19 GB/s sustained (capture.h:28,30)."""
    shape = (ndf, C.NCHK_NIC * C.LANES_PER_CHUNK)
    host = np.random.default_rng(0).integers(
        -256, 256, size=shape, dtype=np.int16)
    nbytes = host.nbytes
    jax.device_put(host).block_until_ready()   # warm the transfer path
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        jax.device_put(host).block_until_ready()
        times.append(time.perf_counter() - t0)
    dt = min(times)
    return {
        "metric": "H2D bytes/s (full 2-D block device_put)",
        "value": nbytes / dt,
        "unit": "bytes/s",
        "block_bytes": nbytes,
        "block_sec": dt,
        "vs_baseline": (nbytes / dt) / 3.19e9,
    }


def bench_e2e(ndf: int, iters: int, depth: int = 2) -> dict:
    """Pipelined end-to-end block loop: host source -> device_put ->
    power step -> fetch, ``depth`` blocks in flight (the PowerPipeline
    discipline). The bar is real time: one 0.884736 s integration per
    block (README.md:2); vs_baseline = stream-time / wall-time."""
    step = make_step()
    shape = (ndf, C.NCHK_NIC * C.LANES_PER_CHUNK)
    rng = np.random.default_rng(0)
    # a few distinct host blocks so neither transfers nor steps can cache
    hosts = [rng.integers(-256, 256, size=shape, dtype=np.int16)
             for _ in range(min(3, iters))]
    np.asarray(step(jax.device_put(hosts[0])))  # compile + warm
    inflight = collections.deque()
    t0 = time.perf_counter()
    for i in range(iters):
        inflight.append(step(jax.device_put(hosts[i % len(hosts)])))
        if len(inflight) > depth:
            np.asarray(inflight.popleft())
    while inflight:
        np.asarray(inflight.popleft())
    dt = (time.perf_counter() - t0) / iters
    stream_sec = ndf * C.TDF_SEC
    return {
        "metric": "end-to-end realtime multiple "
                  "(host->H2D->step->fetch, pipelined)",
        "value": stream_sec / dt,
        "unit": "x realtime",
        "block_sec": dt,
        "block_stream_sec": stream_sec,
        "depth": depth,
        "vs_baseline": stream_sec / dt,
    }


def bench_cells(ndf: int, iters: int, cells) -> dict:
    """Time each (mode, layout) cell; the first cell is the headline."""
    samples_per_block = ndf * C.NSAMP_DF * C.NCHAN * C.NPOL_SAMP
    stream_sec = ndf * C.TDF_SEC
    blocks = {}
    rows = []
    for name, layout, kw in cells:
        if layout not in blocks:
            blocks[layout] = make_block(ndf, layout)
        dt = time_step(stream_fn(dict(kw, layout=layout)), blocks[layout],
                       iters)
        rows.append({"mode": name, "layout": layout, "block_sec": dt,
                     "x_realtime": stream_sec / dt,
                     "samples_per_sec": samples_per_block / dt})
    head = rows[0]
    return {
        "metric": "baseband samples/s/device (unpack+detect+integrate, "
                  f"{head['mode']} {head['layout']})",
        "value": head["samples_per_sec"],
        "unit": "samples/s",
        "vs_baseline": head["samples_per_sec"] / BASELINE_SAMPLES_PER_SEC,
        "cells": rows,
    }


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--quick", action="store_true",
                    help="reduced block, power cell only: a smoke run on "
                    "any backend")
    ap.add_argument("--mode", choices=list(MODES), default=None,
                    help="time one detection mode (default: every mode)")
    ap.add_argument("--device-layout", action="store_true",
                    help="feed series-row blocks (capture --device-layout) "
                    "instead of wire-order blocks (default: both layouts)")
    ap.add_argument("--h2d", action="store_true",
                    help="measure host->device transfer of a full block")
    ap.add_argument("--e2e", action="store_true",
                    help="measure the pipelined source->H2D->step->fetch "
                    "loop including transfers")
    args = ap.parse_args()

    setup_compile_cache()
    dev = device_info()
    if dev["platform"] != "gpu" and not args.quick:
        sys.exit(f"bench.py measures a GPU; found platform "
                 f"'{dev['platform']}' (use --quick for a smoke run)")
    ndf = 256 if args.quick else C.NDF_BLK

    if args.h2d:
        rep = bench_h2d(ndf, max(3, args.iters // 3))
    elif args.e2e:
        rep = bench_e2e(ndf, args.iters)
    else:
        modes = [(m, kw) for m, kw in MODES.items()
                 if args.mode in (None, m)][:1 if args.quick else None]
        layouts = (["rows"] if args.device_layout
                   else ["wire"] if args.quick else ["wire", "rows"])
        cells = [(m, lay, kw) for m, kw in modes for lay in layouts]
        rep = bench_cells(ndf, 2 if args.quick else args.iters, cells)
    rep["device"] = dev
    print(json.dumps(rep))


if __name__ == "__main__":
    main()
