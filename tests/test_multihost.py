"""Multi-host runtime tests: real 2-process execution on CPU.

Two OS processes, 4 virtual devices each, form one 8-device SPMD program
via jax.distributed — the reference's share-nothing per-node deployment
(capture.c:570-584) re-expressed as a single global-mesh pipeline. Output
must match the single-process golden model bit-for-tolerance.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

from paf_baseband2power_tpu import constants as C
from paf_baseband2power_tpu.ops.frame import synthetic_block
from paf_baseband2power_tpu.ops.golden import baseband2power_golden

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_tcp_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _launch(rank: int, nprocs: int, port: int, args, tmp_path):
    env = dict(
        os.environ,
        PYTHONPATH=REPO,
        JAX_PLATFORMS="cpu",
        XLA_FLAGS="--xla_force_host_platform_device_count=4",
        PAFB2P_COORDINATOR=f"localhost:{port}",
        PAFB2P_NUM_PROCS=str(nprocs),
        PAFB2P_PROC_ID=str(rank),
    )
    return subprocess.Popen(
        [sys.executable, "-m", "paf_baseband2power_tpu.cli.paf_multihost",
         *args, "-c", str(tmp_path)],
        env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)


def _run_two_procs(args, tmp_path, timeout=240):
    port = _free_tcp_port()
    procs = [_launch(r, 2, port, args, tmp_path) for r in range(2)]
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=timeout)
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for rc, out, err in outs:
        assert rc == 0, f"rc={rc}\n{out}\n{err}"
    return outs


def _read_power(path, nchan):
    from paf_baseband2power_tpu.io.dada import DadaFileReader

    r = DadaFileReader(path)
    recs = [np.frombuffer(b, "<f4") for b in r.blocks(nchan * 4)]
    r.close()
    return recs


NDF, NCHK, NBLOCKS = 64, 8, 3
NCHAN = NCHK * C.NCHAN_CHK


def _golden(beam, i):
    return baseband2power_golden(
        synthetic_block(rng=1000 * beam + i, ndf=NDF, nchk=NCHK))


def test_two_process_time_sharded(tmp_path):
    """nbeam=1: the host boundary lands on the time axis — each process
    feeds half of every block's frames; psum crosses processes."""
    out = str(tmp_path / "power.dada")
    _run_two_procs(["-a", f"synthetic:{NBLOCKS}", "-b", out, "--nbeam", "1",
                    "--ndf", str(NDF), "--nchk", str(NCHK)], tmp_path)
    recs = _read_power(out, NCHAN)
    assert len(recs) == NBLOCKS
    for i, rec in enumerate(recs):
        np.testing.assert_allclose(rec, _golden(0, i), rtol=1e-5)


def test_two_process_beam_sharded(tmp_path):
    """nbeam=2: the host boundary lands on the beam axis — each process
    owns one whole beam (the reference's per-node-per-beam deployment)."""
    out = str(tmp_path / "power.dada")
    _run_two_procs(["-a", f"synthetic:{NBLOCKS}", "-b", out, "--nbeam", "2",
                    "--ndf", str(NDF), "--nchk", str(NCHK)], tmp_path)
    recs = _read_power(out, NCHAN)
    assert len(recs) == NBLOCKS * 2  # per block: beam 0 then beam 1
    for i in range(NBLOCKS):
        for b in range(2):
            np.testing.assert_allclose(
                recs[2 * i + b], _golden(b, i), rtol=1e-5,
                err_msg=f"block {i} beam {b}")


def test_two_process_ring_fed(tmp_path):
    """Production topology: each host feeds its slice from a LOCAL ring
    buffer (the capture engine's output) into the global SPMD program —
    ring -> make_array_from_process_local_data -> psum across processes."""
    import uuid

    from paf_baseband2power_tpu.io import ringbuffer as rb
    from paf_baseband2power_tpu.io.dada import baseband_header

    ndf_local = NDF // 2  # nbeam=1, 2 procs -> host boundary on time
    keys = [uuid.uuid4().hex[:8] for _ in range(2)]
    try:
        for rank, key in enumerate(keys):
            rb.create(key, ndf_local * NCHK * C.DT_SIZE, NBLOCKS + 1)
            ring = rb.RingBuffer(key)
            ring.lock_write()
            ring.write_header(baseband_header(nchan=NCHK * C.NCHAN_CHK))
            f0 = rank * ndf_local
            for i in range(NBLOCKS):
                blk = synthetic_block(rng=i, ndf=NDF, nchk=NCHK)
                local = blk.reshape(NDF, -1)[f0:f0 + ndf_local]
                view = ring.open_block_write()
                view[:] = np.frombuffer(local.tobytes(), np.uint8)
                ring.close_block_write()
            ring.set_eod()
            ring.unlock_write()
            ring.disconnect()

        out = str(tmp_path / "power.dada")
        port = _free_tcp_port()
        procs = [
            _launch(r, 2, port,
                    ["-a", f"ring:{keys[r]}", "--nbeam", "1",
                     "--ndf", str(NDF), "--nchk", str(NCHK),
                     *(["-b", out] if r == 0 else [])], tmp_path)
            for r in range(2)
        ]
        for p in procs:
            o, e = p.communicate(timeout=240)
            assert p.returncode == 0, f"{o}\n{e}"
        recs = _read_power(out, NCHAN)
        assert len(recs) == NBLOCKS
        for i, rec in enumerate(recs):
            want = baseband2power_golden(
                synthetic_block(rng=i, ndf=NDF, nchk=NCHK))
            np.testing.assert_allclose(rec, want, rtol=1e-5)
    finally:
        for key in keys:
            if rb.exists(key):
                rb.destroy(key)


def test_single_process_runner():
    """The same runner degrades to single-process (8 local devices)."""
    from paf_baseband2power_tpu.runtime.multihost import (
        MultihostRunner, synthetic_local_source)
    from paf_baseband2power_tpu.runtime.pipeline import MemorySink

    runner = MultihostRunner(nbeam_total=2, ndf=NDF, nchk=NCHK)
    assert runner.local_shape[0] == 2  # owns both beams
    sink = MemorySink()
    stats = runner.run(synthetic_local_source(runner, 2), sink)
    assert stats.nblocks == 2
    assert len(sink.records) == 4
    np.testing.assert_allclose(sink.records[0], _golden(0, 0), rtol=1e-5)
    np.testing.assert_allclose(sink.records[1], _golden(1, 0), rtol=1e-5)


def test_local_shape_validation():
    from paf_baseband2power_tpu.runtime.multihost import MultihostRunner

    runner = MultihostRunner(nbeam_total=1, ndf=NDF, nchk=NCHK)
    with pytest.raises(ValueError):
        runner.assemble(np.zeros((1, NDF // 2, 8), np.int16))


def test_two_process_pfb_halo_streaming(tmp_path):
    """PFB across processes AND blocks: the overlap-save halo ppermutes
    from the first time shard of process 1 to the last time shard of
    process 0 within a block, and the cross-BLOCK carry makes the
    2-process K-block stream sum to the one-shot golden over the
    concatenated series (VERDICT r4 missing #1)."""
    from paf_baseband2power_tpu.ops import pfb as _pfb

    nfft, ntap = 16, 4
    out = str(tmp_path / "spec.dada")
    _run_two_procs(["-a", f"synthetic:{NBLOCKS}", "-b", out, "--nbeam", "1",
                    "--ndf", str(NDF), "--nchk", str(NCHK),
                    "--pfb", str(nfft), "--ntap", str(ntap)], tmp_path)
    nchan_f = NCHK * C.NCHAN_CHK * nfft
    recs = _read_power(out, nchan_f)
    assert len(recs) == NBLOCKS
    blocks = [synthetic_block(rng=i, ndf=NDF, nchk=NCHK)
              for i in range(NBLOCKS)]
    # block 0 is one-shot; later blocks include the boundary windows
    np.testing.assert_allclose(
        recs[0], _pfb.pfb_power_golden(blocks[0], nfft, ntap), rtol=2e-4)
    want_total = _pfb.pfb_power_golden(
        np.concatenate(blocks, axis=0), nfft, ntap)
    np.testing.assert_allclose(np.sum(recs, axis=0), want_total, rtol=2e-4)


def test_two_process_composed_spectra(tmp_path):
    """Composed detection across processes: PFB x Stokes x 2-spectra
    waterfall — halo ppermute AND the window scatter/psum cross the
    process boundary."""
    from paf_baseband2power_tpu.ops.pfb import pfb_spectra_golden

    nfft, ntap, nout = 16, 4, 2
    out = str(tmp_path / "spec.dada")
    _run_two_procs(["-a", f"synthetic:{NBLOCKS}", "-b", out, "--nbeam", "1",
                    "--ndf", str(NDF), "--nchk", str(NCHK),
                    "--pfb", str(nfft), "--ntap", str(ntap),
                    "--stokes", "--nspectra", str(nout)], tmp_path)
    rec_floats = nout * 4 * NCHK * C.NCHAN_CHK * nfft
    recs = _read_power(out, rec_floats)
    assert len(recs) == NBLOCKS
    # streaming: block i's waterfall equals groups [i*nout, (i+1)*nout)
    # of the one-shot golden over the concatenated stream
    blocks = [synthetic_block(rng=i, ndf=NDF, nchk=NCHK)
              for i in range(NBLOCKS)]
    want_all = pfb_spectra_golden(np.concatenate(blocks, axis=0), nfft,
                                  ntap, nout=NBLOCKS * nout, stokes=True)
    for i, rec in enumerate(recs):
        want = want_all[i * nout:(i + 1) * nout]
        got = rec.reshape(want.shape)
        np.testing.assert_allclose(got, want, rtol=2e-4,
                                   atol=1e-5 * np.abs(want_all).max(),
                                   err_msg=f"block {i}")


def test_two_process_stokes_scrunch(tmp_path):
    """Non-PFB Stokes waterfall across processes (window-aligned: each
    shard owns whole windows, zero collectives)."""
    from paf_baseband2power_tpu.ops.golden import (
        baseband2stokes_scrunch_golden,
    )

    nout = 8
    out = str(tmp_path / "ss.dada")
    _run_two_procs(["-a", f"synthetic:{NBLOCKS}", "-b", out, "--nbeam", "1",
                    "--ndf", str(NDF), "--nchk", str(NCHK),
                    "--stokes", "--nspectra", str(nout)], tmp_path)
    rec_floats = nout * 4 * NCHAN
    recs = _read_power(out, rec_floats)
    assert len(recs) == NBLOCKS
    for i, rec in enumerate(recs):
        want = baseband2stokes_scrunch_golden(
            synthetic_block(rng=i, ndf=NDF, nchk=NCHK), nout)
        got = rec.reshape(want.shape)
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max(),
                                   err_msg=f"block {i}")


def test_single_process_runner_device_layout():
    """Rows beam-DP runner: series-row slices through the rows steps on
    the CPU mesh, golden parity per beam."""
    from paf_baseband2power_tpu.ops.golden import (
        baseband2stokes_scrunch_golden,
    )
    from paf_baseband2power_tpu.runtime.multihost import (
        MultihostRunner, synthetic_local_source)
    from paf_baseband2power_tpu.runtime.pipeline import MemorySink

    runner = MultihostRunner(nbeam_total=2, ndf=32, nchk=2,
                             stokes=True, nout=2, device_layout=True)
    assert runner.local_shape == (2, 2 * 14, 32, 256)
    sink = MemorySink()
    stats = runner.run(synthetic_local_source(runner, 2), sink)
    assert stats.nblocks == 2
    assert len(sink.records) == 4            # 2 blocks x 2 beams
    for i in range(2):
        for b in range(2):
            want = baseband2stokes_scrunch_golden(
                synthetic_block(rng=1000 * b + i, ndf=32, nchk=2), 2)
            got = sink.records[2 * i + b]
            np.testing.assert_allclose(
                got, want, rtol=1e-4, atol=1e-5 * np.abs(want).max(),
                err_msg=f"block {i} beam {b}")


def test_two_process_device_layout(tmp_path):
    """2-process rows beam-DP: each host feeds its beam's series-row
    slice; per-beam records match the golden model."""
    out = str(tmp_path / "rows_power.dada")
    _run_two_procs(["-a", "synthetic:2", "-b", out, "--nbeam", "2",
                    "--ndf", str(NDF), "--nchk", str(NCHK),
                    "--device-layout"], tmp_path)
    recs = _read_power(out, NCHAN)
    assert len(recs) == 4
    for i in range(2):
        for b in range(2):
            np.testing.assert_allclose(
                recs[2 * i + b], _golden(b, i), rtol=1e-5,
                err_msg=f"block {i} beam {b}")


def test_two_process_device_layout_pfb_streaming(tmp_path):
    """2-process rows beam-DP fine channels: each host's fused-kernel
    carry is a slice of its own series rows (zero collectives), and the
    per-beam stream matches the concatenated golden block for block."""
    from paf_baseband2power_tpu.ops.pfb import pfb_spectra_golden

    nblocks, nfft = 2, 128
    out = str(tmp_path / "rows_spec.dada")
    _run_two_procs(["-a", f"synthetic:{nblocks}", "-b", out, "--nbeam", "2",
                    "--ndf", "32", "--nchk", "2", "--pfb", str(nfft),
                    "--device-layout"], tmp_path, timeout=480)
    nchan_f = 2 * C.NCHAN_CHK * nfft
    recs = _read_power(out, nchan_f)
    assert len(recs) == nblocks * 2
    for b in range(2):
        blocks = [synthetic_block(rng=1000 * b + i, ndf=32, nchk=2)
                  for i in range(nblocks)]
        want_all = pfb_spectra_golden(np.concatenate(blocks, axis=0),
                                      nfft, 4, nout=nblocks)
        for i in range(nblocks):
            np.testing.assert_allclose(
                recs[2 * i + b], want_all[i], rtol=2e-4,
                atol=1e-5 * np.abs(want_all).max(),
                err_msg=f"beam {b} block {i}")


def test_two_process_composed_scatter_output(tmp_path):
    """--scatter-output across processes: the waterfall reduce_scatter
    replaces the allreduce, the gathered records stay golden-identical."""
    from paf_baseband2power_tpu.ops.pfb import pfb_spectra_golden

    nfft, ntap, nout = 16, 4, 8
    out = str(tmp_path / "scat.dada")
    _run_two_procs(["-a", f"synthetic:{NBLOCKS}", "-b", out, "--nbeam", "1",
                    "--ndf", str(NDF), "--nchk", str(NCHK),
                    "--pfb", str(nfft), "--ntap", str(ntap),
                    "--stokes", "--nspectra", str(nout),
                    "--scatter-output"], tmp_path)
    rec_floats = nout * 4 * NCHK * C.NCHAN_CHK * nfft
    recs = _read_power(out, rec_floats)
    assert len(recs) == NBLOCKS
    blocks = [synthetic_block(rng=i, ndf=NDF, nchk=NCHK)
              for i in range(NBLOCKS)]
    want_all = pfb_spectra_golden(np.concatenate(blocks, axis=0), nfft,
                                  ntap, nout=NBLOCKS * nout, stokes=True)
    for i, rec in enumerate(recs):
        want = want_all[i * nout:(i + 1) * nout]
        np.testing.assert_allclose(rec.reshape(want.shape), want,
                                   rtol=2e-4,
                                   atol=1e-5 * np.abs(want_all).max(),
                                   err_msg=f"block {i}")
