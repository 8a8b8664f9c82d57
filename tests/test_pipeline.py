"""Streaming pipeline + CLI integration tests (offline, file mode)."""

import json
import os

import numpy as np
import pytest

from paf_baseband2power_tpu import constants as C
from paf_baseband2power_tpu.io.dada import DadaFileReader
from paf_baseband2power_tpu.ops import frame as F
from paf_baseband2power_tpu.ops.golden import baseband2power_golden
from paf_baseband2power_tpu.runtime import pipeline as RP
from paf_baseband2power_tpu.cli import paf_baseband2power as cli_b2p
from paf_baseband2power_tpu.cli import paf_gen as cli_gen

NDF, NCHK = 32, 8


def test_synthetic_source_pipeline_parity():
    src = RP.SyntheticSource(3, ndf=NDF, nchk=NCHK, seed=5)
    sink = RP.MemorySink()
    stats = RP.PowerPipeline(depth=2).run(src, sink)
    assert stats.nblocks == 3
    assert len(sink.records) == 3
    for i, rec in enumerate(sink.records):
        want = baseband2power_golden(
            F.synthetic_block(rng=5 + i, ndf=NDF, nchk=NCHK)
        )
        np.testing.assert_allclose(rec, want, rtol=1e-5)


def test_pipeline_stats():
    src = RP.SyntheticSource(2, ndf=NDF, nchk=NCHK)
    stats = RP.PowerPipeline(depth=1).run(src, RP.MemorySink())
    assert stats.nbytes_in == 2 * NDF * NCHK * C.DT_SIZE
    assert stats.nbytes_out == 2 * NCHK * C.NCHAN_CHK * 4
    assert stats.elapsed > 0
    assert len(stats.block_seconds) == 2


def test_gen_and_file_pipeline(tmp_path):
    """Full offline flow: paf_gen -> paf_baseband2power -> .dada power."""
    bb = str(tmp_path / "bb.dada")
    pw = str(tmp_path / "pw.dada")
    assert cli_gen.main([
        "-o", bb, "-n", "2", "--ndf", str(NDF), "--nchk", str(NCHK),
        "--seed", "9",
    ]) == 0
    assert os.path.getsize(bb) == C.DADA_HDR_SIZE + 2 * NDF * NCHK * C.DT_SIZE

    assert cli_b2p.main([
        "-a", bb, "-b", pw, "--ndf", str(NDF), "--nchk", str(NCHK),
        "-c", str(tmp_path),
    ]) == 0

    with DadaFileReader(pw) as r:
        # metadata propagated from the baseband stream
        assert r.header["UTC_START"] == "2026-01-01-00:00:00"
        assert r.header.get_int("NCHAN") == NCHK * C.NCHAN_CHK
        assert r.header.get_int("NBIT") == 32
        records = list(r.blocks(NCHK * C.NCHAN_CHK * 4))
    assert len(records) == 2
    for i, rec in enumerate(records):
        got = np.frombuffer(rec, "<f4")
        want = baseband2power_golden(
            F.synthetic_block(rng=9 + i, ndf=NDF, nchk=NCHK)
        )
        np.testing.assert_allclose(got, want, rtol=1e-5)
    # log file written (multilog parity)
    assert os.path.exists(tmp_path / "baseband2power.log")


def test_cli_synthetic_input(tmp_path, capsys):
    pw = str(tmp_path / "pw.dada")
    assert cli_b2p.main([
        "-a", "synthetic:3", "-b", pw, "--ndf", str(NDF), "--nchk", str(NCHK),
        "--stats-json",
    ]) == 0
    stats = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert stats["nblocks"] == 3
    assert stats["samples_per_sec"] > 0
    assert len(stats["block_seconds"]) == 3


def test_cli_mean_mode(tmp_path):
    pw = str(tmp_path / "pw.dada")
    cli_b2p.main(["-a", "synthetic:1", "-b", pw, "--ndf", str(NDF),
                  "--nchk", str(NCHK), "--mean"])
    with DadaFileReader(pw) as r:
        rec = np.frombuffer(r.read_all(), "<f4")
    want = baseband2power_golden(
        F.synthetic_block(rng=0, ndf=NDF, nchk=NCHK), mean=True
    )
    np.testing.assert_allclose(rec, want, rtol=1e-5)


def test_ring_key_detection():
    assert cli_b2p.looks_like_ring_key("dada")
    assert cli_b2p.looks_like_ring_key("adad")
    assert not cli_b2p.looks_like_ring_key("file.dada")
    assert not cli_b2p.looks_like_ring_key("synthetic:2")


def test_pfb_pipeline_streaming_parity(tmp_path):
    """--pfb CLI: streaming PFB with history carry across blocks matches
    the golden model applied to the concatenated stream."""
    from paf_baseband2power_tpu.ops import pfb as _pfb

    nfft, ntap = 32, 4
    bb = str(tmp_path / "bb.dada")
    pw = str(tmp_path / "pw.dada")
    cli_gen.main(["-o", bb, "-n", "2", "--ndf", str(NDF),
                  "--nchk", str(NCHK), "--seed", "30"])
    assert cli_b2p.main([
        "-a", bb, "-b", pw, "--ndf", str(NDF), "--nchk", str(NCHK),
        "--pfb", str(nfft), "--ntap", str(ntap),
    ]) == 0

    with DadaFileReader(pw) as r:
        assert r.header.get_int("NCHAN") == NCHK * 7 * nfft
        assert r.header.get_int("PFB_NFFT") == nfft
        recs = [np.frombuffer(b, "<f4")
                for b in r.blocks(NCHK * 7 * nfft * 4)]
    assert len(recs) == 2

    b1 = F.synthetic_block(rng=30, ndf=NDF, nchk=NCHK)
    b2 = F.synthetic_block(rng=31, ndf=NDF, nchk=NCHK)
    both = np.concatenate([b1, b2], axis=0)
    want_total = _pfb.pfb_power_golden(both, nfft, ntap)
    np.testing.assert_allclose(recs[0] + recs[1], want_total, rtol=2e-4)


def test_monitor_cli(tmp_path, capsys):
    from paf_baseband2power_tpu.io import ringbuffer as rb
    from paf_baseband2power_tpu.cli import paf_monitor
    import uuid
    key = uuid.uuid4().hex[:8]
    rb.create(key, 1024, 4)
    try:
        assert paf_monitor.main([key]) == 0
        out = capsys.readouterr().out
        assert "0/4 blocks full" in out
        with rb.RingBuffer(key) as ring:
            ring.lock_write()
            ring.open_block_write()
            ring.close_block_write()
            ring.unlock_write()
        assert paf_monitor.main([key, "--json"]) == 0
        rec = json.loads(capsys.readouterr().out.strip())
        assert rec["written"] == 1 and rec["full"] == 1
    finally:
        rb.destroy(key)


def test_composed_modes_cli(tmp_path):
    """The detection modes compose: --pfb x --nspectra (waterfall),
    --pfb x --stokes (fine-channel polarimetry), --stokes x --nspectra."""
    from paf_baseband2power_tpu.ops import pfb as _pfb
    from paf_baseband2power_tpu.ops.golden import (
        baseband2stokes_scrunch_golden,
    )

    nfft, ntap, nout = 32, 4, 2
    bb = str(tmp_path / "bb.dada")
    cli_gen.main(["-o", bb, "-n", "1", "--ndf", str(NDF),
                  "--nchk", str(NCHK), "--seed", "40"])
    block = F.synthetic_block(rng=40, ndf=NDF, nchk=NCHK)
    scale = float(np.abs(block).max()) ** 2 * NDF * 128 * 4

    # PFB x waterfall
    pw = str(tmp_path / "wf.dada")
    assert cli_b2p.main([
        "-a", bb, "-b", pw, "--ndf", str(NDF), "--nchk", str(NCHK),
        "--pfb", str(nfft), "--ntap", str(ntap), "--nspectra", str(nout),
    ]) == 0
    nchan_f = NCHK * 7 * nfft
    with DadaFileReader(pw) as r:
        assert r.header.get_int("NSBLK") == nout
        recs = [np.frombuffer(b, "<f4").reshape(nout, nchan_f)
                for b in r.blocks(nout * nchan_f * 4)]
    want = _pfb.pfb_spectra_golden(block, nfft, ntap, nout=nout)
    np.testing.assert_allclose(recs[0], want, rtol=2e-4, atol=1e-5 * scale)

    # PFB x Stokes
    ps = str(tmp_path / "st.dada")
    assert cli_b2p.main([
        "-a", bb, "-b", ps, "--ndf", str(NDF), "--nchk", str(NCHK),
        "--pfb", str(nfft), "--ntap", str(ntap), "--stokes",
    ]) == 0
    with DadaFileReader(ps) as r:
        assert r.header["STOKES"] == "IQUV"
        recs = [np.frombuffer(b, "<f4").reshape(1, 4, nchan_f)
                for b in r.blocks(4 * nchan_f * 4)]
    want = _pfb.pfb_spectra_golden(block, nfft, ntap, stokes=True)
    np.testing.assert_allclose(recs[0], want, rtol=2e-4, atol=1e-5 * scale)

    # Stokes x waterfall (coarse channels)
    ss = str(tmp_path / "ss.dada")
    assert cli_b2p.main([
        "-a", bb, "-b", ss, "--ndf", str(NDF), "--nchk", str(NCHK),
        "--stokes", "--nspectra", str(nout),
    ]) == 0
    with DadaFileReader(ss) as r:
        assert r.header.get_int("NPOL") == 4
        recs = [np.frombuffer(b, "<f4").reshape(nout, 4, NCHK * 7)
                for b in r.blocks(nout * 4 * NCHK * 7 * 4)]
    want = baseband2stokes_scrunch_golden(block, nout)
    np.testing.assert_allclose(recs[0], want, rtol=2e-4, atol=1e-5 * scale)


def test_device_layout_file_replay(tmp_path):
    """A recording made from a device-layout ring (ORDER SERIES header)
    auto-detects as series rows; the PFB step consumes rows directly
    with golden parity. Wire-order synthetic
    input with --device-layout is rejected instead of silently
    misinterpreted."""
    from paf_baseband2power_tpu.io.dada import DadaFileWriter, baseband_header
    from paf_baseband2power_tpu.ops import pfb as _pfb

    ndf, nchk = 64, 2
    block = F.synthetic_block(rng=55, ndf=ndf, nchk=nchk)
    rows = block.transpose(1, 3, 4, 0, 2, 5).reshape(nchk * 14, ndf, 256)
    path = str(tmp_path / "rows.dada")
    w = DadaFileWriter(path, baseband_header(
        nchan=nchk * 7, extra={"ORDER": "SERIES"}))
    w.write(rows.reshape(-1).view(np.uint8))
    w.close()

    out = str(tmp_path / "spec.dada")
    assert cli_b2p.main(["-a", path, "-b", out, "--ndf", str(ndf),
                         "--nchk", str(nchk), "--pfb", "128"]) == 0
    nchan_f = nchk * 7 * 128
    with DadaFileReader(out) as r:
        recs = [np.frombuffer(b, "<f4") for b in r.blocks(nchan_f * 4)]
    want = _pfb.pfb_power_golden(block, 128, 4)
    np.testing.assert_allclose(recs[0], want, rtol=2e-4)

    # wire-order synthetic + --device-layout must be rejected
    import pytest as _pytest
    with _pytest.raises(SystemExit):
        cli_b2p.main(["-a", "synthetic:1", "-b", str(tmp_path / "x.dada"),
                      "--ndf", str(ndf), "--nchk", str(nchk),
                      "--device-layout"])


def test_gen_device_layout_roundtrip(tmp_path):
    """paf_gen --device-layout writes an ORDER SERIES recording that the
    compute CLI auto-detects and consumes through the rows kernels."""
    bb = str(tmp_path / "rows.dada")
    pw = str(tmp_path / "rows_pw.dada")
    assert cli_gen.main([
        "-o", bb, "-n", "2", "--ndf", str(NDF), "--nchk", str(NCHK),
        "--seed", "31", "--device-layout",
    ]) == 0
    with DadaFileReader(bb) as r:
        assert r.header["ORDER"] == "SERIES"
    assert cli_b2p.main([
        "-a", bb, "-b", pw, "--ndf", str(NDF), "--nchk", str(NCHK),
    ]) == 0
    with DadaFileReader(pw) as r:
        records = list(r.blocks(NCHK * C.NCHAN_CHK * 4))
    assert len(records) == 2
    for i, rec in enumerate(records):
        want = baseband2power_golden(
            F.synthetic_block(rng=31 + i, ndf=NDF, nchk=NCHK))
        np.testing.assert_allclose(np.frombuffer(rec, "<f4"), want,
                                   rtol=1e-5)


def test_relayout_roundtrip(tmp_path):
    """paf_relayout: wire -> rows -> wire is byte-identical, and the rows
    intermediate computes golden-parity power via auto-detection."""
    from paf_baseband2power_tpu.cli import paf_relayout as cli_rel

    bb = str(tmp_path / "wire.dada")
    assert cli_gen.main(["-o", bb, "-n", "2", "--ndf", str(NDF),
                         "--nchk", str(NCHK), "--seed", "77"]) == 0
    rows = str(tmp_path / "rows.dada")
    back = str(tmp_path / "back.dada")
    assert cli_rel.main(["-a", bb, "-b", rows, "--ndf", str(NDF),
                         "--nchk", str(NCHK)]) == 0
    with DadaFileReader(rows) as r:
        assert r.header["ORDER"] == "SERIES"
    assert cli_rel.main(["-a", rows, "-b", back, "--ndf", str(NDF),
                         "--nchk", str(NCHK)]) == 0
    raw_a = open(bb, "rb").read()[C.DADA_HDR_SIZE:]
    raw_b = open(back, "rb").read()[C.DADA_HDR_SIZE:]
    assert raw_a == raw_b
    # the rows intermediate is a valid device-layout recording
    pw = str(tmp_path / "pw.dada")
    assert cli_b2p.main(["-a", rows, "-b", pw, "--ndf", str(NDF),
                         "--nchk", str(NCHK)]) == 0
    with DadaFileReader(pw) as r:
        rec = next(iter(r.blocks(NCHK * C.NCHAN_CHK * 4)))
    want = baseband2power_golden(
        F.synthetic_block(rng=77, ndf=NDF, nchk=NCHK))
    np.testing.assert_allclose(np.frombuffer(rec, "<f4"), want, rtol=1e-5)
