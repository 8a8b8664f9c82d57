"""CLI: full-pipeline launcher.

Reference parity (``paf-baseband2power.py:97-131``): parse the INI config,
compute ring block sizes, create both ring buffers, launch the three stages
(disk replay -> device compute -> disk spill) as separate OS processes with
optional CPU pinning, join them, destroy the rings. Also supports a
single-process ``--mode file`` that skips the rings entirely (the
one-process fast path; rings exist for operational parity and multi-process topologies).
"""

from __future__ import annotations

import argparse
import os
import shlex
import subprocess
import sys


def _stage_cmd(module: str, argv: list[str], cpu: int | None) -> list[str]:
    cmd = [sys.executable, "-m", f"paf_baseband2power_tpu.cli.{module}"] + argv
    if cpu is not None:
        # taskset pinning, like paf-baseband2power.py:86-95
        cmd = ["taskset", "-c", str(cpu)] + cmd
    return cmd


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="paf_pipeline")
    ap.add_argument("-c", "--config", default=None, help="INI config file")
    ap.add_argument("-a", "--input", required=True,
                    help="recorded .dada baseband file or synthetic[:N]")
    ap.add_argument("-b", "--outdir", default=".", help="output directory")
    ap.add_argument("-o", "--output", default="power.dada",
                    help="output file name")
    ap.add_argument("--mode", choices=["ring", "file"], default="ring")
    ap.add_argument("--pin", action="store_true",
                    help="taskset-pin stages to CPUs 0/1/2")
    ap.add_argument("--ndf", type=int, default=None,
                    help="frames per block override")
    ap.add_argument("--nchk", type=int, default=None,
                    help="chunk count override")
    ap.add_argument("--pfb", type=int, default=0, metavar="NFFT",
                    help="channelize before detection (forwarded to the "
                    "compute stage; output ring sized accordingly)")
    ap.add_argument("--ntap", type=int, default=4)
    ap.add_argument("--stokes", action="store_true",
                    help="full-Stokes records (4 x nchan)")
    ap.add_argument("--nspectra", type=int, default=1,
                    help="sub-block integration: N spectra per block")
    ap.add_argument("--raw-spill", metavar="NAME", default=None,
                    help="add a fourth stage: a second reader on the "
                    "BASEBAND ring spilling raw blocks to NAME (input "
                    "ring created with NREADER=2 — the dada_db -r 2 "
                    "dual-reader topology)")
    ap.add_argument("--keep-rings", action="store_true")
    ap.add_argument("--lock-rings", action="store_true",
                    help="mlock ring segments in every attaching process "
                    "(the -l in dada_db -l, paf-baseband2power.py:114); "
                    "best effort under RLIMIT_MEMLOCK")
    args = ap.parse_args(argv)

    from ..config import load_config
    from ..runtime.log import open_log

    conf = load_config(args.config)
    if args.ndf:
        conf.diskdb.ndf = args.ndf
    if args.nchk:
        conf.basic.nchk_nic = args.nchk
        conf.baseband2power.nchan = args.nchk * 7
    os.makedirs(args.outdir, exist_ok=True)
    log = open_log("pipeline", args.outdir)

    ndf, nchk = conf.diskdb.ndf, conf.basic.nchk_nic
    out_path = os.path.join(args.outdir, args.output)

    # detection-mode flags forwarded to the compute stage; the output
    # ring block must hold one full record (the reference hard-codes
    # nchan*nbyte = 1344 B, paf-baseband2power.py:79 — composed modes
    # scale it by fine channels, Stokes rows, and spectra per block)
    mode_args = []
    record_floats = nchk * 7
    if args.pfb:
        mode_args += ["--pfb", str(args.pfb), "--ntap", str(args.ntap)]
        record_floats *= args.pfb
    if args.stokes:
        mode_args += ["--stokes"]
        record_floats *= 4
    if args.nspectra > 1:
        mode_args += ["--nspectra", str(args.nspectra)]
        record_floats *= args.nspectra

    if args.mode == "file":
        from .paf_baseband2power import main as b2p
        return b2p(["-a", args.input, "-b", out_path, "-c", args.outdir,
                    "--ndf", str(ndf), "--nchk", str(nchk)] + mode_args)

    from ..io import ringbuffer as rb

    key_in, key_out = conf.diskdb.key, conf.baseband2power.key
    # .key files for operator parity (paf-baseband2power.py:101-112)
    for prefix, key in ((conf.diskdb.kfname_prefix, key_in),
                        (conf.baseband2power.kfname_prefix, key_out)):
        with open(os.path.join(args.outdir, f"{prefix}.key"), "w") as f:
            f.write(f"DADA INFO:\nkey {key}\n")

    for key in (key_in, key_out):
        if rb.exists(key):
            rb.destroy(key)
    # NREADER from the config (dada_db -r, paf-baseband2power.py:114);
    # the raw-spill tap needs a second reader slot
    nreader_in = conf.diskdb.nreader
    if args.raw_spill:
        nreader_in = max(nreader_in, 2)
    rb.create(key_in, conf.diskdb_rbufsz, conf.diskdb.nblk,
              nreader=nreader_in, lock_pages=args.lock_rings)
    out_bufsz = max(conf.baseband2power_rbufsz, record_floats * 4)
    rb.create(key_out, out_bufsz, conf.baseband2power.nblk,
              nreader=conf.baseband2power.nreader,
              lock_pages=args.lock_rings)
    log.info("created rings: %s (%d x %d B), %s (%d x %d B)",
             key_in, conf.diskdb.nblk, conf.diskdb_rbufsz,
             key_out, conf.baseband2power.nblk, out_bufsz)

    procs = {}
    try:
        if args.input.startswith("synthetic"):
            n = int(args.input.split(":", 1)[1]) if ":" in args.input else 2
            gen_file = os.path.join(args.outdir, "synthetic_bb.dada")
            subprocess.run(_stage_cmd("paf_gen", [
                "-o", gen_file, "-n", str(n), "--ndf", str(ndf),
                "--nchk", str(nchk)], None), check=True)
            args.input = gen_file

        stages = [
            ("diskdb", "paf_diskdb",
             # forward the config's SOD flag (DiskdbConf SOD,
             # paf-baseband2power.conf:14 / paf-baseband2power.py:86)
             ["-a", key_in, "-b", args.outdir, "-c", args.input,
              "-e", str(conf.diskdb.sod)], 0),
            ("baseband2power", "paf_baseband2power",
             ["-a", f"ring:{key_in}", "-b", f"ring:{key_out}",
              "-c", args.outdir,
              "--ndf", str(ndf), "--nchk", str(nchk)] + mode_args, 1),
            ("dbdisk", "paf_dbdisk",
             ["-k", key_out, "-D", args.outdir, "-o", args.output, "-W"], 2),
        ]
        if args.raw_spill:
            stages.append(
                ("rawspill", "paf_dbdisk",
                 ["-k", key_in, "-D", args.outdir, "-o", args.raw_spill,
                  "-W"], 3))
        for name, module, stage_args, cpu in stages:
            cmd = _stage_cmd(module, stage_args, cpu if args.pin else None)
            log.info("launch %s: %s", name, shlex.join(cmd))
            procs[name] = subprocess.Popen(cmd)

        rc = 0
        for name, p in procs.items():
            p.wait()
            log.info("%s exited rc=%d", name, p.returncode)
            rc = rc or p.returncode
        return rc
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.terminate()
        if not args.keep_rings:
            for key in (key_in, key_out):
                if rb.exists(key):
                    rb.destroy(key)


if __name__ == "__main__":
    sys.exit(main())
