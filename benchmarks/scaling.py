"""Weak-scaling benchmark: samples/s at growing mesh sizes.

Measures the sharded power step at 1, 2, 4, ... devices with the per-device
problem size held constant (weak scaling), reporting throughput and
efficiency vs the 1-device baseline — the BASELINE.json "scaling eff.
1 chip -> 1 host -> N hosts" axis.

With fewer devices than mesh points the multi-device points run on a
virtual CPU mesh (functional; the wall-clock numbers are meaningful
relative to the 1-CPU-device point, not to any accelerator). On an
oversubscribed virtual mesh the
classic per-device efficiency is meaningless (N virtual devices share the
same cores), so the report also carries ``total_throughput_ratio`` =
sps(N)/sps(1): its ideal is ~1.0 there (sharding and collectives add no
overhead), and on real hardware it equals N x weak-scaling efficiency.
On a multi-GPU host, run unmodified: devices are whatever `jax.devices()`
reports after `init_distributed()`.

Usage: python benchmarks/scaling.py [--ndf-per-dev 512] [--iters 5]
       [--out results.json]
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

import jax
import jax.numpy as jnp


def measure(mesh, ndf_local: int, iters: int) -> float:
    from paf_baseband2power_tpu import constants as C
    from paf_baseband2power_tpu.parallel import sharded as S
    from paf_baseband2power_tpu.ops.frame import synthetic_block
    from paf_baseband2power_tpu.parallel.mesh import TIME_AXIS

    n_time = mesh.shape[TIME_AXIS]
    block = synthetic_block(rng=0, ndf=ndf_local * n_time, nchk=C.NCHK_NIC)
    step = S.make_sharded_power_step(mesh)
    x = S.shard_block(jnp.asarray(block), mesh)
    np.asarray(step(x))
    t0 = time.perf_counter()
    out = None
    for _ in range(iters):
        out = step(x)
    np.asarray(out)
    dt = (time.perf_counter() - t0) / iters
    nsamp = block.shape[0] * C.NSAMP_DF * C.NCHAN * C.NPOL_SAMP
    return nsamp / dt


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--ndf-per-dev", type=int, default=512)
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--cpu", action="store_true",
                    help="force the CPU backend (use with "
                    "XLA_FLAGS=--xla_force_host_platform_device_count=N "
                    "for a virtual mesh)")
    ap.add_argument("--out", default=None, help="write results JSON here")
    args = ap.parse_args()
    if args.cpu:
        jax.config.update("jax_platforms", "cpu")

    sys.path.insert(0, ".")
    from paf_baseband2power_tpu.parallel import mesh as M

    ndev = len(jax.devices())
    sizes = [n for n in (1, 2, 4, 8, 16, 32) if n <= ndev]
    results = []
    base = None
    for n in sizes:
        mesh = M.make_mesh(n_time=n, devices=jax.devices()[:n])
        sps = measure(mesh, args.ndf_per_dev, args.iters)
        base = base or sps
        results.append({"devices": n, "samples_per_sec": sps,
                        "weak_scaling_eff": sps / (base * n),
                        "total_throughput_ratio": sps / base})
        print(json.dumps(results[-1]))
    if args.out:
        import os

        report = {
            "backend": jax.default_backend(),
            "physical_cores": len(os.sched_getaffinity(0)),
            "virtual_mesh": jax.default_backend() == "cpu",
            "ndf_per_device": args.ndf_per_dev,
            "points": results,
        }
        with open(args.out, "w") as f:
            json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
