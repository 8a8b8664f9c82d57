"""CLI: real-time UDP capture into a ring buffer.

Reference parity (``paf_capture.c:59-112`` getopt): key (-a), block frames
(-c), NIC/IP (-e equivalent: --ip), epoch file (-g), length (-j), directory
(-k). The reference derives its bind IP from the hostname
(``10.17.<node>.<nic>``, ``paf_capture.c:114-118``); here --ip takes it
directly (with the same 10.17.x.y convention available via --node/--nic).

After alignment the stream header (UTC_START/PICOSECONDS/FREQ) is
registered into the ring before data flows, like ``register_header``
(``capture.c:727-789``); at exit the per-port packet-loss statistics table
is printed (``capture.c:700-725``).
"""

from __future__ import annotations

import argparse
import sys

from .. import constants as C


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="paf_capture")
    ap.add_argument("-a", "--key", default=C.DEFAULT_KEY_IN, help="ring key")
    ap.add_argument("-b", "--sod", type=int, default=1,
                    help="start-of-data flag (paf_capture.c -b parity): "
                    "1 marks SOD at the first captured block so readers "
                    "can wait for the observation start; 0 captures "
                    "without a SOD mark")
    ap.add_argument("-c", "--ndf", type=int, default=C.NDF_BLK,
                    help="frames per ring block")
    ap.add_argument("--ip", default=None, help="bind address")
    ap.add_argument("--node", type=int, default=None,
                    help="derive ip as 10.17.<node>.<nic>")
    ap.add_argument("--nic", type=int, default=1)
    ap.add_argument("-p", "--port-base", type=int, default=C.PORT_BASE)
    ap.add_argument("-n", "--nports", type=int, default=C.NPORT_NIC)
    ap.add_argument("--nchk", type=int, default=C.NCHK_NIC)
    ap.add_argument("--freq-base", type=float, default=1000.0,
                    help="FREQ of chunk 0 (MHz)")
    ap.add_argument("--chunk-bw", type=float, default=7.0)
    ap.add_argument("-g", "--epoch-file", default=None,
                    help="epoch->MJD lookup override")
    ap.add_argument("-j", "--length", type=float, default=0.0,
                    help="capture length in seconds (0 = until silent)")
    ap.add_argument("-k", "--dir", default=None, help="log directory")
    ap.add_argument("--timeout", type=float, default=float(C.PRD_SEC),
                    help="socket receive timeout")
    ap.add_argument("--ndf-check", type=int, default=C.NDF_CHECK)
    ap.add_argument("--tbuf-ndf", type=int, default=C.TBUF_NDF)
    ap.add_argument("--cpu-base", type=int, default=-1,
                    help="pin capture threads starting at this CPU")
    ap.add_argument("--numa-node", type=int, default=-1,
                    help="NUMA-aware pinning: thread i -> node*10 + i "
                    "(the reference's affinity, sync.c:48-59)")
    ap.add_argument("--create-ring", type=int, metavar="NBLK", default=0,
                    help="create the ring with NBLK blocks first")
    ap.add_argument("--beam", type=int, default=-1,
                    help="accept only this beam id (-1 = any)")
    ap.add_argument("--no-zero", action="store_true",
                    help="skip zero-filling blocks (reference behavior)")
    ap.add_argument("--device-layout", action="store_true",
                    help="corner-turn frames on the host (SIMD) into the "
                    "series-row layout; the ring header carries "
                    "ORDER SERIES so consumers pick the rows view (fine-"
                    "channel steps then skip the device corner turn)")
    args = ap.parse_args(argv)

    from ..io import ringbuffer as rb
    from ..io.capture import CaptureConf, CaptureEngine
    from ..io.dada import baseband_header
    from ..ops.time_utils import load_epoch_table, start_time
    from ..runtime.log import open_log

    log = open_log("paf_capture", args.dir)

    ip = args.ip
    if ip is None:
        ip = f"10.17.{args.node}.{args.nic}" if args.node is not None \
            else "0.0.0.0"

    bufsz = args.ndf * args.nchk * C.DT_SIZE
    if args.create_ring:
        if rb.exists(args.key):
            rb.destroy(args.key)
        rb.create(args.key, bufsz, args.create_ring)
        log.info("created ring '%s': %d x %d B", args.key, args.create_ring,
                 bufsz)

    conf = CaptureConf(
        ip=ip, port_base=args.port_base, nports=args.nports,
        ring_key=args.key, ndf_blk=args.ndf, nchk=args.nchk,
        freq_base=args.freq_base, chunk_bw=args.chunk_bw,
        tbuf_ndf=args.tbuf_ndf, timeout_sec=args.timeout,
        ndf_check=args.ndf_check, length_sec=args.length,
        cpu_base=args.cpu_base, zero_blocks=not args.no_zero,
        beam=args.beam, numa_node=args.numa_node,
        device_layout=args.device_layout,
    )
    with CaptureEngine(conf) as eng:
        nports = eng.probe()
        log.info("probe: %d active ports, %d chunks", nports,
                 eng.active_chunks)
        if args.sod:
            # mark SOD before any block commits: the first captured
            # block is the observation start (capture.c:622-639 parity)
            with rb.RingBuffer(args.key) as sring:
                sring.set_sod()
        eng.start()

        table = load_epoch_table(args.epoch_file) if args.epoch_file else None
        utc, ps = start_time(eng.epoch, eng.ref_sec, eng.ref_idf,
                             epoch_table=table)
        hdr = baseband_header(
            utc_start=utc, picoseconds=ps, freq=eng.freq_center,
            nchan=args.nchk * C.NCHAN_CHK,
            extra={"ORDER": "SERIES"} if args.device_layout else None,
        )
        with rb.RingBuffer(args.key) as ring:
            ring.write_header(hdr)
        log.info("UTC_START: %s PICOSECONDS: %d FREQ: %.1f", utc, ps,
                 eng.freq_center)

        rc = eng.wait()

        # statistics table (capture.c:700-725; per-port elapsed_time
        # capture.c:450,552)
        print(f"{'port':>6} {'expected':>10} {'received':>10} "
              f"{'dropped':>8} {'invalid':>8} {'loss':>8} {'elapsed':>9}")
        for st in eng.port_stats():
            print(f"{st.port:>6} {st.expected:>10} {st.received:>10} "
                  f"{st.dropped:>8} {st.invalid:>8} {st.loss_rate:>8.4f} "
                  f"{st.elapsed:>9.3f}")
            log.info("port %d: expected=%d received=%d dropped=%d invalid=%d "
                     "loss=%.4f elapsed=%.3f s",
                     st.port, st.expected, st.received, st.dropped,
                     st.invalid, st.loss_rate, st.elapsed)
        log.info("blocks committed: %d, force switches: %d",
                 eng.blocks_committed, eng.force_switches)
        if rc:
            log.error("capture quit: a port fell a full block behind")
        return rc


if __name__ == "__main__":
    sys.exit(main())
