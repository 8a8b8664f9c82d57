"""CLI: the device compute stage (reference parity: ``paf_baseband2power``).

Reference flags (``paf_baseband2power.cu:20-27``):
  -a  input  (ring-buffer key in the reference; here a .dada file, a ring
      key once the native ring is attached, or ``synthetic[:N]``)
  -b  output (.dada file or ring key)
  -c  directory for runtime logs
  -d  device ordinal

Extra flags cover what the reference hard-codes (block geometry, mean mode,
overlap depth).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

from .. import constants as C


def looks_like_ring_key(s: str) -> bool:
    try:
        int(s, 16)
    except ValueError:
        return False
    return len(s) <= 8 and not os.path.exists(s)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="paf_baseband2power",
        description="Detect baseband data with original channels and "
        "integrate the detected data in time",
    )
    ap.add_argument("-a", "--input", required=True,
                    help=".dada file, ring key, or synthetic[:NBLOCKS]")
    ap.add_argument("-b", "--output", required=True,
                    help="output .dada file or ring key")
    ap.add_argument("-c", "--dir", default=None, help="log directory")
    ap.add_argument("-d", "--device", type=int, default=0,
                    help="device ordinal")
    ap.add_argument("--ndf", type=int, default=C.NDF_BLK,
                    help="frames per block")
    ap.add_argument("--nchk", type=int, default=C.NCHK_NIC,
                    help="frequency chunks")
    ap.add_argument("--mean", action="store_true",
                    help="average instead of sum over the window")
    ap.add_argument("--stokes", action="store_true",
                    help="full-Stokes detection (I,Q,U,V per channel; "
                    "NPOL 4 records) instead of total power")
    ap.add_argument("--nspectra", type=int, default=1, metavar="N",
                    help="output N spectra per block (sub-block "
                    "integration; N must divide the block's frame count; "
                    "default 1 = the reference's one integration per block)")
    ap.add_argument("--depth", type=int, default=2,
                    help="blocks in flight (ring NBLK analogue)")
    ap.add_argument("--fetch-every", type=int, default=1,
                    help="batch this many power outputs per device fetch "
                    "(amortizes the fixed fetch round trip; records reach "
                    "the sink unchanged, N-1 blocks later)")
    ap.add_argument("--no-warmup", action="store_true",
                    help="skip precompiling the power step (live ring "
                    "sources need the warmup or the first-block compile "
                    "stalls the ring and trips the capture fall-behind "
                    "policy)")
    ap.add_argument("--pfb", type=int, default=0, metavar="NFFT",
                    help="channelize with an NFFT-point polyphase "
                    "filterbank before detection")
    ap.add_argument("--ntap", type=int, default=4, help="PFB taps")
    ap.add_argument("--window", default="hamming",
                    choices=["hamming", "hanning", "rect"])
    ap.add_argument("--stats-json", action="store_true",
                    help="print run statistics as JSON")
    ap.add_argument("--profile", metavar="DIR", default=None,
                    help="write a jax.profiler trace to DIR "
                    "(the nvprof-wrapper analogue, run.py:13-16)")
    ap.add_argument("--debug", action="store_true",
                    help="per-block output validation + verbose logging "
                    "(the -DDEBUG rebuild analogue)")
    ap.add_argument("--device-layout", action="store_true",
                    help="input blocks are host-corner-turned series rows "
                    "(capture --device-layout); auto-detected from the "
                    "ring header's ORDER SERIES field")
    ap.add_argument("--wait-sod", action="store_true",
                    help="ring input: start at the marked observation "
                    "boundary, discarding pre-SOD blocks (mid-stream "
                    "attach)")
    args = ap.parse_args(argv)

    from ..runtime import setup_compile_cache

    setup_compile_cache()

    import jax

    if args.device:
        devs = jax.devices()
        if args.device >= len(devs):
            # reference behavior: single-visible-device fixup
            # (paf_baseband2power.cu:87-90)
            args.device = 0
        jax.config.update("jax_default_device", devs[args.device])

    from ..runtime.pipeline import (
        FileSink,
        FileSource,
        PowerPipeline,
        SyntheticSource,
    )
    from ..io.dada import output_header

    # --- source -----------------------------------------------------------
    # "ring:KEY" addresses a ring buffer explicitly; a bare hex token is
    # also treated as a ring key (the reference's dada key convention) —
    # non-hex ring keys MUST use the explicit prefix or they are read as
    # file paths
    if args.input.startswith("synthetic"):
        if args.device_layout:
            ap.error("--device-layout needs a ring or recording whose "
                     "blocks were corner-turned by the capture engine; "
                     "the synthetic source yields wire-order blocks")
        n = int(args.input.split(":", 1)[1]) if ":" in args.input else 4
        source = SyntheticSource(n, ndf=args.ndf, nchk=args.nchk)
        in_header = None
    elif args.input.startswith("ring:") or looks_like_ring_key(args.input):
        from ..io.ringbuffer import RingSource

        key = args.input.split(":", 1)[1] \
            if args.input.startswith("ring:") else args.input
        source = RingSource(key, ndf=args.ndf, nchk=args.nchk,
                            wait_sod=args.wait_sod)
        in_header = source.header
        if not args.device_layout and \
                (in_header or {}).get("ORDER") == "SERIES":
            args.device_layout = True
        if args.device_layout:
            source.set_layout("rows")
    else:
        source = FileSource(args.input, ndf=args.ndf, nchk=args.nchk,
                            layout="rows" if args.device_layout else None)
        in_header = source.header
        args.device_layout = source.layout == "rows"

    # --- sink -------------------------------------------------------------
    nchan_out = args.nchk * C.NCHAN_CHK * (args.pfb or 1)
    hdr = output_header(
        utc_start=(in_header or {}).get("UTC_START", "unset"),
        picoseconds=(in_header or {}).get("PICOSECONDS", "unset"),
        freq=(in_header or {}).get("FREQ", "unset"),
        bw=(in_header or {}).get("BW", "unset"),
        nchan=nchan_out,
        tint_sec=args.ndf * C.TDF_SEC,   # = TINT at the standard 8192
    )
    if args.pfb:
        hdr["PFB_NFFT"] = str(args.pfb)
        hdr["PFB_NTAP"] = str(args.ntap)
        hdr["PFB_WINDOW"] = args.window
    if args.stokes:
        # full-Stokes records: 4 x nchan float32 per block, I/Q/U/V rows
        hdr["NPOL"] = "4"
        hdr["STOKES"] = "IQUV"
    if args.nspectra > 1:
        # finer output cadence: TSAMP shrinks by the sub-integration factor
        hdr["TSAMP"] = str(float(hdr["TSAMP"]) / args.nspectra)
        hdr["NSBLK"] = str(args.nspectra)
    if args.output.startswith("ring:") or looks_like_ring_key(args.output):
        from ..io.ringbuffer import RingSink

        key = args.output.split(":", 1)[1] \
            if args.output.startswith("ring:") else args.output
        sink = RingSink(key, header=hdr)
    else:
        sink = FileSink(args.output, header=hdr)

    from ..runtime.debug import profile_trace, set_debug

    if args.debug:
        set_debug(True)
    pipe = PowerPipeline(mean=args.mean, depth=args.depth, log_dir=args.dir,
                         pfb_nfft=args.pfb, pfb_ntap=args.ntap,
                         pfb_window=args.window,
                         fetch_every=args.fetch_every, stokes=args.stokes,
                         nout=args.nspectra,
                         device_layout=args.device_layout)
    if not args.no_warmup:
        pipe.warmup(args.ndf, args.nchk)
    with profile_trace(args.profile):
        stats = pipe.run(source, sink)
    if args.stats_json:
        print(json.dumps({
            "nblocks": stats.nblocks,
            "elapsed_sec": stats.elapsed,
            "samples_per_sec": stats.samples_per_sec,
            "realtime_x": stats.realtime_fraction,
            "block_seconds": stats.block_seconds,
        }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
