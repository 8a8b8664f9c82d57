#!/usr/bin/env python3
"""On-card smoke run of the PAF baseband->power chain on one NVIDIA GPU.

Drives the main path through the entry points a user calls, at the full
block geometry (8192 frames x 48 chunks, 2.8 GB per block), and checks what
comes out against the float64 goldens. Phases:

  a  device: the card's name and power limit (nvidia-smi), the native
     library built from the committed sources, JAX's platform is ``gpu``
  b  modes: every detection mode x block layout PowerPipeline dispatches —
     compile seconds, memory, golden parity, step time (information only)
  c  cli: ``paf_gen`` -> ``launcher`` ring chain (diskdb -> shm ring ->
     compute -> ring -> dbdisk) in direct-power mode, and
     ``paf_baseband2power`` PFB / Stokes runs on wire and rows recordings
  d  gpu tests: ``pytest -m gpu``
  e  four cards (``--four-cards`` only, and then no other phase): beam-
     parallel multihost runner and time-sharded streaming PFB on 4 cards

This parent process never imports JAX: each phase runs in a child process
that has the card to itself. Any failed phase makes the exit code non-zero.
Only when every phase passed is the last line of stdout
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": N}}``.

Usage:
    python chip_smoke.py                 # phases a-d on one card
    python chip_smoke.py --four-cards    # phase e on four cards
The parent always runs the full geometry. Rehearsal of one phase's child at
a reduced geometry on the CPU (prints no result line):
    JAX_PLATFORMS=cpu python chip_smoke.py --child modes --ndf 2048 --nchk 2
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import threading
import time
import uuid

REPO = os.path.dirname(os.path.abspath(__file__))
PACKAGE = "paf_baseband2power_tpu"
NDF, NCHK = 8192, 48          # full block geometry
HBM_PEAK = {"NVIDIA H100 80GB HBM3": 3.35e12}   # bytes/s, NVIDIA data sheet
ONE_CARD_PHASES = ["device", "modes", "cli", "gpu_tests"]
DEADLINE = {"device": 300, "modes": 700, "cli": 800, "gpu_tests": 500,
            "four": 1100}
DIRECT_RTOL, DIRECT_ATOL = 1e-5, 1e-6     # atol x max|golden|
FINE_RTOL, FINE_ATOL = 2e-4, 1e-5         # atol x max|golden|
# Fine modes must also stay under this share of their bound: the explicit
# bf16x3 matmuls read ~0.01 of it on the H100, implicit TF32 0.3-0.8, so a
# matmul that fell back to TF32 fails here and not only in a CPU-side scan.
FINE_LIMIT = 0.1


# --------------------------------------------------------------------------
# parent: phase selection and child processes (no JAX here)
# --------------------------------------------------------------------------

def select_phases(four_cards: bool) -> list[str]:
    """Child names to run: ``four`` alone with ``--four-cards``, else every
    one-card phase in order."""
    return ["four"] if four_cards else list(ONE_CARD_PHASES)


def result_line(device: dict) -> str:
    """The last line of a passing run."""
    return json.dumps({"ok": True, "device": {
        "platform": device["platform"], "kind": device["kind"],
        "count": int(device["count"])}})


def card_lines() -> list[str]:
    """``name, power limit`` per card, as nvidia-smi reports them."""
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    lines = [ln.strip() for ln in r.stdout.splitlines() if ln.strip()]
    if not lines:
        raise RuntimeError("nvidia-smi lists no card")
    return lines


def run_child(name: str, env: dict) -> tuple[int, dict]:
    """Run one phase's child at the full geometry, relaying its output;
    returns (rc, device) where ``device`` is the last ``device: {...}``
    line it printed. The child's whole process group is killed at its
    deadline and at exit."""
    cmd = [sys.executable, os.path.abspath(__file__), "--child", name]
    p = subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.STDOUT, text=True,
                         start_new_session=True)
    expired = threading.Event()

    def expire():
        expired.set()
        _kill_group(p)

    timer = threading.Timer(DEADLINE[name], expire)
    timer.start()
    device = {}
    try:
        for line in p.stdout:
            print(f"[{name}] {line}", end="", flush=True)
            if line.startswith("device: "):
                device = json.loads(line[len("device: "):])
        rc = p.wait()
    finally:
        timer.cancel()
        _kill_group(p)
    if expired.is_set():
        print(f"[{name}] killed at its {DEADLINE[name]} s deadline",
              flush=True)
    return rc, device


def _kill_group(p: subprocess.Popen) -> None:
    try:
        os.killpg(p.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass


def child_main(argv: list[str]) -> int:
    """One phase's child: ``--child NAME [--ndf N --nchk N]``. Only the
    child takes a geometry, for a reduced rehearsal on the CPU."""
    ap = argparse.ArgumentParser(prog="chip_smoke.py --child")
    ap.add_argument("name", choices=sorted(CHILDREN))
    ap.add_argument("--ndf", type=int, default=NDF)
    ap.add_argument("--nchk", type=int, default=NCHK)
    args = ap.parse_args(argv)
    return CHILDREN[args.name](args)


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else list(argv)
    if argv[:1] == ["--child"]:
        return child_main(argv[1:])
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card phase (needs 4 GPUs)")
    args = ap.parse_args(argv)

    if not os.path.isdir(os.path.join(REPO, PACKAGE)):
        print(f"chip_smoke: {PACKAGE}/ not found beside {__file__}",
              file=sys.stderr)
        return 2
    names = select_phases(args.four_cards)
    try:
        cards = card_lines()
    except (RuntimeError, OSError, subprocess.SubprocessError) as e:
        print(f"chip_smoke: {e}", file=sys.stderr)
        return 2
    for line in cards:
        print(f"card: {line}", flush=True)
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["SMOKE_CARD"] = cards[0]
    env.setdefault("JAX_PLATFORMS", "cuda")
    failed, device = [], {}
    for name in names:
        t0 = time.time()
        rc, dev = run_child(name, env)
        device = dev or device
        print(f"phase {name}: {'ok' if rc == 0 else f'FAILED rc={rc}'} "
              f"({time.time() - t0:.1f} s)", flush=True)
        if rc:
            failed.append(name)
    if failed or device.get("platform") != "gpu":
        print(f"chip_smoke: failed phases {failed or ['device']}",
              file=sys.stderr)
        return 1
    print(result_line(device), flush=True)
    return 0


# --------------------------------------------------------------------------
# children (each imports JAX and owns the card while it runs)
# --------------------------------------------------------------------------

def _say(*parts) -> None:
    print(*parts, flush=True)


def _report_device(expect_count: int | None = None) -> dict:
    import jax

    devs = jax.devices()
    d = {"platform": devs[0].platform, "kind": devs[0].device_kind,
         "count": len(devs)}
    _say("device: " + json.dumps(d))
    if d["platform"] != "gpu":
        raise SystemExit(f"JAX platform is '{d['platform']}', not 'gpu'")
    if expect_count and d["count"] < expect_count:
        raise SystemExit(f"need {expect_count} cards, JAX sees {d['count']}")
    return d


def parity(got, want, rtol: float, atol_rel: float,
           limit: float = 1.0) -> dict:
    """Compare ``got`` with a golden: the bound is ``|got - want| <=
    rtol*|want| + atol_rel*max|want|`` elementwise (the atol term covers
    Stokes Q/U/V, which noise drives near zero by cancellation). Returns
    the max relative error, the worst bound ratio (<= ``limit`` passes)
    and ok."""
    import numpy as np

    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    if got.shape != want.shape:
        return {"ok": False, "shape": [got.shape, want.shape]}
    diff = np.abs(got - want)
    scale = float(np.abs(want).max())
    bound = rtol * np.abs(want) + atol_rel * scale
    nz = np.abs(want) > atol_rel * scale
    rel = float((diff[nz] / np.abs(want[nz])).max()) if nz.any() else 0.0
    ratio = float((diff / np.where(bound > 0, bound, 1.0)).max())
    ok = bool(np.isfinite(got).all() and ratio <= limit)
    return {"ok": ok, "max_rel": rel, "bound_ratio": ratio}


def fine_parity(got, want) -> dict:
    """``parity`` at the fine-channel bound, held to ``FINE_LIMIT`` of it."""
    return parity(got, want, FINE_RTOL, FINE_ATOL, limit=FINE_LIMIT)


def direct_golden(name: str, block):
    """Float64 golden of a coarse-channel mode, chunk by chunk (a whole
    block cast to float64 would take 11 GB of host memory)."""
    import numpy as np

    from paf_baseband2power_tpu.ops import golden as G

    fn = {"power": G.baseband2power_golden,
          "tscrunch64": lambda b: G.baseband2power_scrunch_golden(b, 64),
          "stokes": G.baseband2stokes_golden,
          "stokes_tscrunch64":
              lambda b: G.baseband2stokes_scrunch_golden(b, 64)}[name]
    parts = [fn(block[:, c:c + 1]) for c in range(block.shape[1])]
    return np.concatenate(parts, axis=-1)


def fine_golden(kw: dict, blocks, nchk_cmp: int):
    """Float64 golden of a fine-channel mode over the first ``nchk_cmp``
    chunks of consecutive blocks streamed with the carry: spectrum group
    per block (end-row convention), ``(nblk*nout, [4,] nchk_cmp*7*nfft)``."""
    import numpy as np

    from paf_baseband2power_tpu.ops.pfb import pfb_spectra_golden

    both = np.concatenate([b[:, :nchk_cmp] for b in blocks], axis=0)
    nout = kw.get("nout", 1)
    return pfb_spectra_golden(both, kw["nfft"], 4, nout=len(blocks) * nout,
                              stokes=kw.get("stokes", False))


def _gb(n) -> str:
    return f"{n / 1e9:.3f} GB"


def child_device(args) -> int:
    """Phase a: build the native library and check JAX's platform."""
    r = subprocess.run(["make", "-B", "-C", os.path.join(PACKAGE, "native")],
                       cwd=REPO, capture_output=True, text=True)
    _say(r.stdout.strip()[-2000:])
    if r.returncode:
        _say(r.stderr.strip()[-4000:])
        _say("native library build FAILED")
        return 1
    _say("native library built from the committed sources")
    _report_device()
    return 0


def run_cell(kw: dict, layout: str, dev_blocks: list, n_time: int = 5
             ) -> dict:
    """Compile, run and time one mode x layout on device blocks.

    Fine-channel (stateful) modes run both blocks in a row with the
    carry; coarse modes run the first block. Returns the host outputs
    (one per block run), the compile seconds, ``memory_analysis`` of the
    step and the seconds per step (chained calls, one sync).
    """
    import numpy as np

    import jax

    from paf_baseband2power_tpu.runtime.pipeline import make_step

    fn = jax.jit(make_step(layout=layout, **kw))
    x0, x1 = dev_blocks
    tc = time.time()
    if kw.get("nfft"):
        c0 = fn.lower(x0, None).compile()
        o0, h = c0(x0, None)
        compiled = fn.lower(x1, h).compile()
        o1, h = compiled(x1, h)
        outs = [o0, o1]
    else:
        compiled = fn.lower(x0).compile()
        outs = [compiled(x0)]
    jax.block_until_ready(outs)
    t_compile = time.time() - tc
    ts = time.time()
    for i in range(n_time):
        if kw.get("nfft"):
            out, h = compiled(dev_blocks[i % 2], h)
        else:
            out = compiled(x0)
    jax.block_until_ready(out)
    return {"outs": [np.asarray(o) for o in outs], "compile_sec": t_compile,
            "memory": compiled.memory_analysis(),
            "step_sec": (time.time() - ts) / n_time}


def cell_parity(kw: dict, outs: list, want, nchk_cmp: int) -> tuple:
    """(parity, stacked outputs) of one cell against its golden: coarse
    modes over every chunk at the direct bound, fine-channel modes over
    their first ``nchk_cmp`` chunks, both blocks, at the fine bound held
    to ``FINE_LIMIT``."""
    import numpy as np

    if not kw.get("nfft"):
        return parity(outs[0], want, DIRECT_RTOL, DIRECT_ATOL), outs[0]
    got = np.concatenate([o.reshape((-1,) + want.shape[1:-1]
                                    + (o.shape[-1],)) for o in outs])
    nf = nchk_cmp * 7 * kw["nfft"]
    return fine_parity(got[..., :nf], want), got


def child_modes(args) -> int:
    """Phase b: every mode x layout at the given geometry."""
    import jax

    from paf_baseband2power_tpu import constants as C
    from paf_baseband2power_tpu.ops.frame import block_to_rows, synthetic_block
    from paf_baseband2power_tpu.runtime.pipeline import MODES

    dev = _report_device() if jax.default_backend() == "gpu" else {
        "kind": jax.devices()[0].device_kind}
    card = os.environ.get("SMOKE_CARD", "not measured")
    peak = HBM_PEAK.get(dev["kind"])
    ndf, nchk = args.ndf, args.nchk
    t0 = time.time()
    blocks = [synthetic_block(rng=i, ndf=ndf, nchk=nchk) for i in range(2)]
    rows = [block_to_rows(b) for b in blocks]
    _say(f"generated 2 blocks of {ndf}x{nchk} ({_gb(blocks[0].nbytes)} each)"
         f" in {time.time() - t0:.1f} s")
    t0 = time.time()
    dev_in = {"wire": [jax.device_put(b.reshape(ndf, -1)) for b in blocks],
              "rows": [jax.device_put(r) for r in rows]}
    jax.block_until_ready(dev_in)
    h2d = time.time() - t0
    _say(f"H2D of 4 blocks from pageable host memory: {h2d:.3f} s, "
         f"{4 * blocks[0].nbytes / h2d / 1e9:.2f} GB/s (information only)")
    nchk_cmp = min(2, nchk)
    ok = True
    for name, kw in MODES.items():
        want = (fine_golden(kw, blocks, nchk_cmp) if kw.get("nfft")
                else direct_golden(name, blocks[0]))
        got = {}
        for layout in ("wire", "rows"):
            cell = run_cell(kw, layout, dev_in[layout])
            res, got[layout] = cell_parity(kw, cell["outs"], want, nchk_cmp)
            ok &= res["ok"]
            ma, step = cell["memory"], cell["step_sec"]
            mem = (f"temp={_gb(ma.temp_size_in_bytes)} "
                   f"args={_gb(ma.argument_size_in_bytes)} "
                   f"out={_gb(ma.output_size_in_bytes)}" if ma else "n/a")
            share = (f"{ndf * nchk * C.DT_SIZE / peak / step:.4f}"
                     if peak else "not measured")
            stats = jax.devices()[0].memory_stats() or {}
            _say(f"mode {name:27s} {layout:4s} "
                 f"{'ok' if res['ok'] else 'PARITY FAILED'} "
                 f"max_rel={res.get('max_rel')} "
                 f"bound_ratio={res.get('bound_ratio')} "
                 f"compile={cell['compile_sec']:.2f}s mem[{mem}] "
                 f"peak_bytes_in_use={stats.get('peak_bytes_in_use', 'n/a')} "
                 f"step={step * 1e3:.3f}ms hbm_share={share} "
                 f"realtime_x={ndf * C.TDF_SEC / step:.2f} [{card}]")
        if kw.get("nfft"):
            res = fine_parity(got["rows"], got["wire"])
            ok &= res["ok"]
            _say(f"mode {name:27s} wire-vs-rows over {nchk} chunks "
                 f"{'ok' if res['ok'] else 'FAILED'} "
                 f"max_rel={res.get('max_rel')} "
                 f"bound_ratio={res.get('bound_ratio')}")
    return 0 if ok else 1


def _run_cli(cmd: list[str], env: dict, timeout: float) -> str:
    _say("$ " + " ".join(cmd))
    r = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                       text=True, timeout=timeout)
    if r.returncode:
        raise RuntimeError(f"{cmd[2]} rc={r.returncode}\n"
                           f"{r.stdout[-3000:]}\n{r.stderr[-3000:]}")
    return r.stdout


def _records(path: str, shape: tuple):
    import numpy as np

    from paf_baseband2power_tpu.io.dada import DadaFileReader

    with DadaFileReader(path) as rd:
        data = np.frombuffer(rd.read_all(), "<f4")
    return data.reshape((-1,) + shape)


def child_cli(args) -> int:
    """Phase c: the offline chain through the CLIs, records vs goldens."""
    import numpy as np

    from paf_baseband2power_tpu import constants as C
    from paf_baseband2power_tpu.ops.frame import synthetic_block

    ndf, nchk, nblk = args.ndf, args.nchk, 3
    block_nbytes = ndf * nchk * C.DT_SIZE
    env = dict(os.environ)
    py = [sys.executable, "-m"]
    cli = f"{PACKAGE}.cli."
    geo = ["--ndf", str(ndf), "--nchk", str(nchk)]
    nchan = nchk * C.NCHAN_CHK
    nchk_cmp = min(2, nchk)
    blocks = [synthetic_block(rng=i, ndf=ndf, nchk=nchk)
              for i in range(nblk)]      # paf_gen's seeds 0, 1, 2
    direct = {m: np.stack([direct_golden(m, b) for b in blocks])
              for m in ("power", "stokes")}
    fine_runs = [("pfb128", ["--pfb", "128"], {"nfft": 128}),
                 ("stokes", ["--stokes"], None),
                 ("pfb1024_waterfall64_stokes",
                  ["--pfb", "1024", "--nspectra", "64", "--stokes"],
                  {"nfft": 1024, "nout": 64, "stokes": True})]
    fine = {m: fine_golden(kw, blocks, nchk_cmp)
            for m, _, kw in fine_runs if kw}
    shm = shutil.disk_usage("/dev/shm").free
    depth = min(C.DEFAULT_NBLK_IN, (shm - (64 << 20)) // block_nbytes)
    _say(f"/dev/shm free {_gb(shm)}: input ring depth {depth} blocks")
    ok = depth >= 2
    if not ok:
        _say("FAILED: /dev/shm holds fewer than 2 blocks")
    work = tempfile.mkdtemp(prefix="chip_smoke_")
    _say(f"work dir {work}: {_gb(shutil.disk_usage(work).free)} free")
    # rings of this run only: another checkout's rings keep their keys
    ring_keys = [uuid.uuid4().hex[:8] for _ in range(2)]
    try:
        for layout in ("wire", "rows"):
            bb = os.path.join(work, f"{layout}.dada")
            _run_cli(py + [cli + "paf_gen", "-o", bb, "-n", str(nblk)] + geo
                     + (["--device-layout"] if layout == "rows" else []),
                     env, 600)
            if layout == "wire" and depth >= 2:
                conf = os.path.join(work, "ring.conf")
                with open(conf, "w") as f:
                    f.write(f"[DiskdbConf]\nNBLK: {depth}\n"
                            f"KEY: {ring_keys[0]}\n"
                            f"[Baseband2powerConf]\nKEY: {ring_keys[1]}\n")
                out = os.path.join(work, "ring_out")
                _run_cli(py + [cli + "launcher", "-c", conf, "-a", bb,
                               "-b", out, "-o", "power.dada",
                               "--mode", "ring"] + geo, env, 600)
                got = _records(os.path.join(out, "power.dada"), (nchan,))
                res = parity(got, direct["power"], DIRECT_RTOL, DIRECT_ATOL)
                log = open(os.path.join(out, "baseband2power.log")).read()
                rt = re.findall(r"([0-9.]+)x real time", log)
                for logname in sorted(os.listdir(out)):
                    if logname.endswith(".log"):   # the stages' timeline
                        for line in open(os.path.join(out, logname)):
                            _say(f"  {logname}: {line.rstrip()}")
                ok &= res["ok"] and len(got) == nblk
                _say(f"cli launcher ring power wire: {len(got)} records "
                     f"{'ok' if res['ok'] else 'PARITY FAILED'} "
                     f"max_rel={res.get('max_rel')} "
                     f"bound_ratio={res.get('bound_ratio')} "
                     f"realtime_x={rt[-1] if rt else 'n/a'}")
            for name, flags, kw in fine_runs:
                out = os.path.join(work, f"{layout}_{name}.dada")
                stdout = _run_cli(py + [cli + "paf_baseband2power", "-a", bb,
                                        "-b", out, "--stats-json"]
                                  + geo + flags, env, 600)
                stats = json.loads(stdout.strip().splitlines()[-1])
                if kw:
                    want = fine[name]
                    got = _records(out, want.shape[1:-1]
                                   + (nchan * kw["nfft"],))
                    got = got.reshape((-1,) + want.shape[1:-1]
                                      + (got.shape[-1],))
                    nf = nchk_cmp * C.NCHAN_CHK * kw["nfft"]
                    res = fine_parity(got[..., :nf], want)
                else:
                    got = _records(out, (4, nchan))
                    res = parity(got, direct["stokes"], DIRECT_RTOL,
                                 DIRECT_ATOL)
                ok &= res["ok"] and stats["nblocks"] == nblk
                _say(f"cli paf_baseband2power {name} {layout}: "
                     f"{stats['nblocks']} blocks "
                     f"{'ok' if res['ok'] else 'PARITY FAILED'} "
                     f"max_rel={res.get('max_rel')} "
                     f"bound_ratio={res.get('bound_ratio')} "
                     f"realtime_x={stats['realtime_x']:.3f} (file read, "
                     f"H2D, step and write; per-block s "
                     f"{[round(s, 3) for s in stats['block_seconds']]})")
                os.remove(out)
            os.remove(bb)
    except (RuntimeError, subprocess.SubprocessError, KeyError,
            ValueError) as e:
        _say(f"FAILED: {e}")
        ok = False
    finally:
        shutil.rmtree(work, ignore_errors=True)
        from paf_baseband2power_tpu.io import ringbuffer as rb

        for key in ring_keys:       # left behind if the launcher was killed
            if rb.exists(key):
                rb.destroy(key)
    return 0 if ok else 1


def child_gpu_tests(args) -> int:
    """Phase d: the tests marked ``gpu``."""
    env = dict(os.environ, JAX_PLATFORMS="cuda")
    r = subprocess.run(
        [sys.executable, "-m", "pytest", "-m", "gpu", "tests/", "-q",
         "-p", "no:cacheprovider", "-rs"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=450)
    _say(r.stdout[-4000:])
    _say(r.stderr[-2000:])
    passed = re.search(r"(\d+) passed", r.stdout)
    return 0 if r.returncode == 0 and passed else 1


def child_four(args) -> int:
    """Phase e: beam-parallel and time-sharded paths over four cards."""
    import numpy as np

    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from paf_baseband2power_tpu.ops.frame import block_to_rows, synthetic_block
    from paf_baseband2power_tpu.parallel import mesh as M
    from paf_baseband2power_tpu.parallel import sharded as S
    from paf_baseband2power_tpu.runtime.multihost import MultihostRunner
    from paf_baseband2power_tpu.runtime.pipeline import MemorySink, make_step

    if jax.default_backend() == "gpu":
        _report_device(expect_count=4)
    devs = jax.devices()[:4]
    if len(devs) < 4:
        raise SystemExit(f"need 4 devices, have {len(jax.devices())}")
    ndf, nchk, nbeam, nblk = args.ndf, args.nchk, 4, 2
    ok = True

    def placement(x) -> set:
        return {s.device.id for s in x.addressable_shards}

    def timed(fn, *a, n=5):
        jax.block_until_ready(fn(*a))
        t = time.time()
        for _ in range(n):
            out = fn(*a)
        jax.block_until_ready(out)
        return (time.time() - t) / n

    # 1. beam-parallel through the multihost runner (what paf_multihost
    #    runs): 4 beams on 4 cards, wire and rows, vs one card (card 0)
    beams = [[synthetic_block(rng=1000 * b + i, ndf=ndf, nchk=nchk)
              for i in range(nblk)] for b in range(nbeam)]
    for layout in ("wire", "rows"):
        for nfft in (0, 128):
            runner = MultihostRunner(nbeam_total=nbeam, ndf=ndf, nchk=nchk,
                                     pfb_nfft=nfft,
                                     device_layout=layout == "rows")
            local = [np.stack([block_to_rows(beams[b][i]) if layout == "rows"
                               else beams[b][i].reshape(ndf, -1)
                               for b in range(nbeam)]) for i in range(nblk)]
            x = runner.assemble(local[0])
            cards = placement(x)
            sink = MemorySink()
            t = time.time()
            runner.run(iter(local), sink=sink, fetch_every=1)
            wall = (time.time() - t) / nblk
            got = np.stack(sink.records).reshape(
                (nblk, nbeam) + sink.records[0].shape)
            one = make_step(nfft=nfft, layout=layout)
            worst = 0.0
            for b in range(nbeam):
                h = None
                for i in range(nblk):
                    xi = jax.device_put(local[i][b], devs[0])
                    if nfft:
                        want, h = one(xi, h)
                    else:
                        want = one(xi)
                    want = np.asarray(want)
                    res = fine_parity(got[i, b].reshape(want.shape), want)
                    worst = max(worst, res.get("bound_ratio", np.inf))
                    ok &= res["ok"]
            ok &= len(cards) == 4
            _say(f"four-card beam-parallel runner {layout} "
                 f"{'pfb' + str(nfft) if nfft else 'power'}: input shards "
                 f"on cards {sorted(cards)}, per-block wall {wall * 1e3:.2f}"
                 f" ms (incl. allgather), vs card-0 step bound_ratio="
                 f"{worst:.3g} {'ok' if worst <= FINE_LIMIT else 'FAILED'}")
            del x, local

    # 2. time-sharded streaming PFB: ppermute halo + psum over 4 cards
    from paf_baseband2power_tpu.ops.pfb import make_streaming_pfb

    nfft = 128
    mesh = M.make_mesh(n_time=4, n_chunk=1, devices=devs)
    step = S.make_sharded_pfb_step(mesh, nfft, streaming=True)
    one = make_streaming_pfb(nfft)
    blocks = beams[0]
    outs, h, h1 = [], None, None
    for i, blk in enumerate(blocks):
        x = S.shard_block(blk, mesh)
        if i == 0:
            _say(f"time-sharded input shards on cards {sorted(placement(x))}")
            ok &= len(placement(x)) == 4
        o, h = step(x, h)
        w, h1 = one(jax.device_put(blk, devs[0]), h1)
        res = fine_parity(np.asarray(o), np.asarray(w))
        ok &= res["ok"]
        outs.append(np.asarray(o))
        _say(f"time-sharded streaming pfb{nfft} block {i}: output on cards "
             f"{sorted(placement(o))}, vs card-0 streaming step "
             f"{'ok' if res['ok'] else 'FAILED'} "
             f"bound_ratio={res['bound_ratio']:.3g}")
    want = fine_golden({"nfft": nfft}, blocks, min(2, nchk))
    nf = min(2, nchk) * 7 * nfft
    res = fine_parity(np.stack(outs)[:, :nf], want)
    ok &= res["ok"]
    _say(f"time-sharded streaming pfb{nfft} vs 2-chunk golden: "
         f"{'ok' if res['ok'] else 'FAILED'} max_rel={res['max_rel']} "
         f"bound_ratio={res['bound_ratio']:.3g}")
    x = S.shard_block(blocks[1], mesh)
    wall = timed(lambda a, b: step(a, b)[0], x, h)
    _say(f"time-sharded streaming step wall {wall * 1e3:.2f} ms")

    # the collectives alone, from the wall clock (information only)
    halo = jax.device_put(
        jnp.zeros((4, nchk, 7, 2, 3 * nfft), jnp.complex64),
        NamedSharding(mesh, P(M.TIME_AXIS)))
    part = jax.device_put(jnp.zeros((4, nchk * 7 * nfft), jnp.float32),
                          NamedSharding(mesh, P(M.TIME_AXIS)))
    perm = jax.jit(jax.shard_map(
        lambda v: jax.lax.ppermute(v, M.TIME_AXIS,
                                   [(i, i - 1) for i in range(1, 4)]),
        mesh=mesh, in_specs=P(M.TIME_AXIS), out_specs=P(M.TIME_AXIS)))
    psum = jax.jit(jax.shard_map(
        lambda v: jax.lax.psum(v, M.TIME_AXIS), mesh=mesh,
        in_specs=P(M.TIME_AXIS), out_specs=P()))
    _say(f"collective wall: ppermute halo ({halo.nbytes / 4e6:.2f} MB/card)"
         f" {timed(perm, halo) * 1e3:.3f} ms, psum spectra "
         f"({part.nbytes / 4e6:.2f} MB/card) {timed(psum, part) * 1e3:.3f} ms "
         f"[{os.environ.get('SMOKE_CARD', 'not measured')}]")
    return 0 if ok else 1


CHILDREN = {"device": child_device, "modes": child_modes, "cli": child_cli,
            "gpu_tests": child_gpu_tests, "four": child_four}

if __name__ == "__main__":
    sys.exit(main())
