"""CLI: multi-host SPMD pipeline driver.

One instance runs per host. Bootstrap is env-driven (cluster launchers):
  PAFB2P_COORDINATOR  host:port of process 0
  PAFB2P_NUM_PROCS    total processes
  PAFB2P_PROC_ID      this process's rank
(unset -> single process; a multi-process job needs all three.)

Each host feeds only its owned (beam, frame) slice — from a local ring
buffer (the capture engine's output) or the deterministic synthetic
feeder — and rank 0 sinks the gathered spectra. This is the reference's
share-nothing per-node deployment (capture.c:570-584) re-expressed as one
SPMD program; see runtime/multihost.py.
"""

from __future__ import annotations

import argparse
import json
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="paf_multihost")
    ap.add_argument("-a", "--input", default="synthetic:4",
                    help="synthetic[:N] or ring:<key> (local slice feeder)")
    ap.add_argument("-b", "--output", default=None,
                    help="rank-0 output .dada power file")
    ap.add_argument("-c", "--dir", default=None, help="log directory")
    ap.add_argument("--nbeam", type=int, default=1, help="total beams")
    ap.add_argument("--ndf", type=int, default=64,
                    help="frames per global block")
    ap.add_argument("--nchk", type=int, default=8, help="frequency chunks")
    ap.add_argument("--mean", action="store_true")
    ap.add_argument("--pfb", type=int, default=0, metavar="NFFT",
                    help="fine-channelize (PFB) before detection; the "
                    "overlap-save halo crosses hosts")
    ap.add_argument("--ntap", type=int, default=4, help="PFB taps")
    ap.add_argument("--stokes", action="store_true",
                    help="full-Stokes records (composes with --pfb)")
    ap.add_argument("--nspectra", type=int, default=1,
                    help="sub-block integration: N spectra per block "
                    "(composes with --pfb/--stokes)")
    ap.add_argument("--device-layout", action="store_true",
                    help="feed series-row (ORDER SERIES) blocks; beams "
                    "run data-parallel through the rows steps with zero "
                    "collectives")
    ap.add_argument("--scatter-output", action="store_true",
                    help="reduce_scatter composed fine-channel spectra "
                    "over the time axis instead of allreducing (half the "
                    "collective bytes of the waterfall psum; needs "
                    "n_time | nspectra)")
    ap.add_argument("--wait-sod", action="store_true",
                    help="ring feeder: start at the marked observation "
                    "boundary, discarding pre-SOD blocks (mid-stream "
                    "attach; every host must see the mark on its ring)")
    ap.add_argument("--fetch-every", type=int, default=4)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--stats-json", action="store_true")
    args = ap.parse_args(argv)

    from ..runtime import setup_compile_cache

    setup_compile_cache()

    from ..runtime.multihost import MultihostRunner, synthetic_local_source
    from ..runtime.pipeline import FileSink, MemorySink

    runner = MultihostRunner(nbeam_total=args.nbeam, ndf=args.ndf,
                             nchk=args.nchk, mean=args.mean,
                             log_dir=args.dir, pfb_nfft=args.pfb,
                             pfb_ntap=args.ntap, stokes=args.stokes,
                             nout=args.nspectra,
                             device_layout=args.device_layout,
                             scatter_output=args.scatter_output)

    if args.input.startswith("synthetic"):
        n = int(args.input.split(":", 1)[1]) if ":" in args.input else 4
        source = synthetic_local_source(runner, n, seed=args.seed)
    elif args.input.startswith("ring:"):
        from ..io.ringbuffer import RingSource

        key = args.input.split(":", 1)[1]
        if runner.local_shape[0] != 1:
            raise SystemExit("ring feeder supports one local beam per host")
        if args.device_layout:
            nbeam_l, nseries, ndf_l, seg = runner.local_shape
            ring = RingSource(key, ndf=ndf_l, nchk=args.nchk,
                              layout="rows", wait_sod=args.wait_sod)
            source = (blk.reshape(1, nseries, ndf_l, seg) for blk in ring)
        else:
            nbeam_l, ndf_l, lanes = runner.local_shape
            ring = RingSource(key, ndf=ndf_l, nchk=args.nchk,
                              wait_sod=args.wait_sod)
            source = (blk.reshape(1, ndf_l, -1) for blk in ring)
        # layout mismatch = silently transposed garbage; the runner's
        # step is already built for args.device_layout, so unlike
        # paf_baseband2power (which auto-adopts the header) this must
        # reject the contradiction outright
        ring_order = (ring.header or {}).get("ORDER")
        if args.device_layout != (ring_order == "SERIES"):
            raise SystemExit(
                f"ring '{key}' holds ORDER={ring_order or 'TF'} blocks "
                f"but --device-layout={'on' if args.device_layout else 'off'}"
                " — pass the flag matching the capture layout")
    else:
        raise SystemExit(f"unknown input '{args.input}'")

    import jax

    sink = None
    if jax.process_index() == 0:
        sink = FileSink(args.output) if args.output else MemorySink()
    stats = runner.run(source, sink, fetch_every=args.fetch_every)

    if args.stats_json:
        print(json.dumps({
            "process": jax.process_index(),
            "nprocs": jax.process_count(),
            "mesh": {k: int(v) for k, v in runner.mesh.shape.items()},
            "nblocks": stats.nblocks,
            "elapsed": stats.elapsed,
            "realtime_x": stats.realtime_fraction,
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
