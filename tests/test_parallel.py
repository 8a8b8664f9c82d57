"""Multi-device sharding tests on the virtual 8-device CPU mesh."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from paf_baseband2power_tpu import constants as C
from paf_baseband2power_tpu.ops import frame as F
from paf_baseband2power_tpu.ops.golden import baseband2power_golden
from paf_baseband2power_tpu.parallel import mesh as M
from paf_baseband2power_tpu.parallel import sharded as S


@pytest.fixture(scope="module")
def block():
    return F.synthetic_block(rng=21, ndf=64, nchk=C.NCHK_NIC)


def _run(mesh, block, **kw):
    step = S.make_sharded_power_step(mesh, **kw)
    sharded = S.shard_block(jnp.asarray(block), mesh)
    return np.asarray(step(sharded))


def test_mesh_shapes():
    m = M.make_mesh()
    assert m.devices.shape == (8, 1)
    m = M.make_mesh(n_time=4, n_chunk=2)
    assert m.devices.shape == (4, 2)
    m = M.make_mesh(n_chunk=4)
    assert m.devices.shape == (2, 4)
    with pytest.raises(ValueError):
        M.make_mesh(n_time=3, n_chunk=3)


def test_time_sharded_power_parity(block):
    got = _run(M.make_mesh(n_time=8), block)
    want = baseband2power_golden(block)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_chunk_sharded_power_parity(block):
    got = _run(M.make_mesh(n_chunk=8), block)
    want = baseband2power_golden(block)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_2d_sharded_power_parity(block):
    got = _run(M.make_mesh(n_time=4, n_chunk=2), block)
    want = baseband2power_golden(block)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_2d_sharded_mean(block):
    got = _run(M.make_mesh(n_time=2, n_chunk=4), block, mean=True)
    want = baseband2power_golden(block, mean=True)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_output_sharding_layout(block):
    mesh = M.make_mesh(n_time=2, n_chunk=4)
    step = S.make_sharded_power_step(mesh)
    out = step(S.shard_block(jnp.asarray(block), mesh))
    assert out.shape == (C.NCHAN,)
    # output is sharded over the chunk axis only
    assert out.sharding.spec == jax.sharding.PartitionSpec(M.CHUNK_AXIS)


# ---------------------------------------------------------------------------
# Sharded PFB (halo exchange over the time axis)
# ---------------------------------------------------------------------------

from paf_baseband2power_tpu.ops import pfb as _pfb

NFFT, NTAP = 32, 4


@pytest.fixture(scope="module")
def pfb_block():
    return F.synthetic_block(rng=41, ndf=64, nchk=8)


def _run_pfb(mesh, block, **kw):
    step = S.make_sharded_pfb_step(mesh, NFFT, NTAP, **kw)
    return np.asarray(step(S.shard_block(jnp.asarray(block), mesh)))


def test_sharded_pfb_single_time_parity(pfb_block):
    got = _run_pfb(M.make_mesh(n_time=1, n_chunk=8), pfb_block)
    want = _pfb.pfb_power_golden(pfb_block, NFFT, NTAP)
    np.testing.assert_allclose(got, want, rtol=2e-4)


def test_sharded_pfb_time_halo_parity(pfb_block):
    """Time-sharded PFB with ppermute halo matches the one-shot golden."""
    got = _run_pfb(M.make_mesh(n_time=8), pfb_block)
    want = _pfb.pfb_power_golden(pfb_block, NFFT, NTAP)
    np.testing.assert_allclose(got, want, rtol=2e-4)


def test_sharded_pfb_2d_parity(pfb_block):
    got = _run_pfb(M.make_mesh(n_time=4, n_chunk=2), pfb_block)
    want = _pfb.pfb_power_golden(pfb_block, NFFT, NTAP)
    np.testing.assert_allclose(got, want, rtol=2e-4)


def test_sharded_pfb_mean(pfb_block):
    got = _run_pfb(M.make_mesh(n_time=2, n_chunk=4), pfb_block, mean=True)
    want = _pfb.pfb_power_golden(pfb_block, NFFT, NTAP, mean=True)
    np.testing.assert_allclose(got, want, rtol=2e-4)


# ---------------------------------------------------------------------------
# Multi-beam (data-parallel) meshes
# ---------------------------------------------------------------------------

def test_multibeam_power_parity():
    """(beam, time, chunk) mesh: per-beam spectra match per-beam golden."""
    nbeam = 2
    blocks = np.stack([
        F.synthetic_block(rng=60 + b, ndf=16, nchk=8) for b in range(nbeam)
    ])
    mesh = M.make_beam_mesh(n_beam=2, n_time=2, n_chunk=2)
    step = S.make_multibeam_power_step(mesh)
    sharded = jax.device_put(
        jnp.asarray(blocks),
        jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec(
                M.BEAM_AXIS, M.TIME_AXIS, M.CHUNK_AXIS)))
    out = np.asarray(step(sharded))
    assert out.shape == (nbeam, 8 * C.NCHAN_CHK)
    for b in range(nbeam):
        want = baseband2power_golden(blocks[b])
        np.testing.assert_allclose(out[b], want, rtol=1e-5)


def test_sharded_stokes_parity():
    """(time, chunk) mesh full-Stokes: psum'd partials match golden."""
    from paf_baseband2power_tpu.ops.golden import baseband2stokes_golden

    block = F.synthetic_block(rng=80, ndf=16, nchk=8)
    mesh = M.make_mesh(n_time=4, n_chunk=2)
    step = S.make_sharded_stokes_step(mesh)
    x = jax.device_put(
        jnp.asarray(block.reshape(16, -1)),
        jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec(M.TIME_AXIS, M.CHUNK_AXIS)))
    out = np.asarray(step(x))
    want = baseband2stokes_golden(block)
    assert out.shape == (4, 8 * C.NCHAN_CHK)
    np.testing.assert_allclose(out, want, rtol=5e-4, atol=1e-2)
    np.testing.assert_allclose(out[0], want[0], rtol=1e-5)


def test_sharded_scrunch_parity_and_alignment():
    """Window-aligned time sharding needs zero collectives; misaligned
    nout is rejected."""
    from paf_baseband2power_tpu.ops.golden import (
        baseband2power_scrunch_golden)

    block = F.synthetic_block(rng=81, ndf=32, nchk=8)
    mesh = M.make_mesh(n_time=4, n_chunk=2)
    step = S.make_sharded_scrunch_step(mesh, nout=8)
    x = jax.device_put(
        jnp.asarray(block.reshape(32, -1)),
        jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec(M.TIME_AXIS, M.CHUNK_AXIS)))
    out = np.asarray(step(x))
    want = baseband2power_scrunch_golden(block, 8)
    np.testing.assert_allclose(out, want, rtol=1e-5)
    with pytest.raises(ValueError):
        S.make_sharded_scrunch_step(mesh, nout=6)  # 4 shards !| 6 windows


def test_multibeam_power_2d_parity():
    """2-D-per-beam step (the production layout): per-beam golden parity."""
    nbeam = 2
    blocks = np.stack([
        F.synthetic_block(rng=70 + b, ndf=16, nchk=8) for b in range(nbeam)
    ])
    mesh = M.make_beam_mesh(n_beam=2, n_time=2, n_chunk=2)
    step = S.make_multibeam_power_step_2d(mesh)
    stacked = blocks.reshape(nbeam, 16, -1)  # (beam, ndf, lanes)
    sharded = jax.device_put(
        jnp.asarray(stacked),
        jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec(
                M.BEAM_AXIS, M.TIME_AXIS, M.CHUNK_AXIS)))
    out = np.asarray(step(sharded))
    assert out.shape == (nbeam, 8 * C.NCHAN_CHK)
    for b in range(nbeam):
        np.testing.assert_allclose(
            out[b], baseband2power_golden(blocks[b]), rtol=1e-5)
    # mean mode normalizes by the global frame count across time shards
    step_m = S.make_multibeam_power_step_2d(mesh, mean=True)
    out_m = np.asarray(step_m(sharded))
    np.testing.assert_allclose(
        out_m[0], baseband2power_golden(blocks[0], mean=True), rtol=1e-5)


def test_beam_mesh_validation():
    with pytest.raises(ValueError):
        M.make_beam_mesh(n_beam=3, n_time=2, n_chunk=2)
    m = M.make_beam_mesh(n_beam=8)
    assert m.shape == {"beam": 8, "time": 1, "chunk": 1}


def test_run_multibeam_runtime():
    """Streaming multibeam runtime: per-beam sinks receive per-beam spectra."""
    from paf_baseband2power_tpu.runtime import pipeline as RP
    from paf_baseband2power_tpu.runtime.multibeam import run_multibeam

    mesh = M.make_beam_mesh(n_beam=2, n_time=2, n_chunk=2)
    sources = [RP.SyntheticSource(3, ndf=16, nchk=8, seed=100 * b)
               for b in range(2)]
    sinks = [RP.MemorySink(), RP.MemorySink()]
    stats = run_multibeam(sources, mesh, sinks)
    assert stats.nblocks == 3
    for b in range(2):
        assert len(sinks[b].records) == 3
        for i, rec in enumerate(sinks[b].records):
            want = baseband2power_golden(
                F.synthetic_block(rng=100 * b + i, ndf=16, nchk=8))
            np.testing.assert_allclose(rec, want, rtol=1e-5)


def test_run_multibeam_validation():
    from paf_baseband2power_tpu.runtime import pipeline as RP
    from paf_baseband2power_tpu.runtime.multibeam import run_multibeam

    mesh = M.make_beam_mesh(n_beam=2, n_time=4)
    with pytest.raises(ValueError):
        run_multibeam([RP.SyntheticSource(1, 16, 8)], mesh, [RP.MemorySink()])


# ---------------------------------------------------------------------------
# Sharded composed spectra (PFB x waterfall x Stokes with halo exchange)
# ---------------------------------------------------------------------------

def _run_spectra(mesh, block, **kw):
    step = S.make_sharded_spectra_step(mesh, NFFT, NTAP, **kw)
    return np.asarray(step(S.shard_block(jnp.asarray(block), mesh)))


def _spectra_close(got, want, rtol=2e-4):
    atol = 1e-5 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


@pytest.mark.parametrize("nout,stokes", [(4, False), (1, True), (4, True)])
def test_sharded_spectra_time_halo_parity(pfb_block, nout, stokes):
    """Composed modes across 8 time shards: ppermute halos + window
    scatter by end-row slot reproduce the one-shot golden even when shard
    boundaries do not align with output spectra."""
    got = _run_spectra(M.make_mesh(n_time=8), pfb_block, nout=nout,
                       stokes=stokes)
    want = _pfb.pfb_spectra_golden(pfb_block, NFFT, NTAP, nout=nout,
                                   stokes=stokes)
    _spectra_close(got, want)


def test_sharded_spectra_2d_and_mean(pfb_block):
    got = _run_spectra(M.make_mesh(n_time=4, n_chunk=2), pfb_block,
                       nout=4, stokes=True, mean=True)
    want = _pfb.pfb_spectra_golden(pfb_block, NFFT, NTAP, nout=4,
                                   stokes=True, mean=True)
    _spectra_close(got, want)


def test_sharded_spectra_unaligned_groups(pfb_block):
    """nout=2 over 8 time shards: four shards' windows fold into each
    output spectrum, crossing every shard boundary."""
    got = _run_spectra(M.make_mesh(n_time=8), pfb_block, nout=2)
    want = _pfb.pfb_spectra_golden(pfb_block, NFFT, NTAP, nout=2)
    _spectra_close(got, want)


def test_sharded_stokes_scrunch_parity():
    from paf_baseband2power_tpu.ops.golden import (
        baseband2stokes_scrunch_golden,
    )

    block = F.synthetic_block(rng=55, ndf=64, nchk=8)
    mesh = M.make_mesh(n_time=4, n_chunk=2)
    step = S.make_sharded_stokes_scrunch_step(mesh, nout=8)
    x = jax.device_put(jnp.asarray(block.reshape(64, -1)),
                       jax.sharding.NamedSharding(
                           mesh, jax.sharding.PartitionSpec(
                               M.TIME_AXIS, M.CHUNK_AXIS)))
    got = np.asarray(step(x))
    want = baseband2stokes_scrunch_golden(block, 8)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    with pytest.raises(ValueError):
        S.make_sharded_stokes_scrunch_step(mesh, nout=6)  # 4 !| 6


def test_multibeam_rows_steps_parity():
    """Beam-parallel device-layout steps: beam-stacked rows blocks run
    the rows steps per beam shard with zero collectives."""
    from paf_baseband2power_tpu.ops import pfb as _pfb
    from paf_baseband2power_tpu.ops.golden import (
        baseband2stokes_scrunch_golden,
    )

    nbeam, ndf, nchk = 2, 32, 2
    blocks = np.stack([
        F.synthetic_block(rng=80 + b, ndf=ndf, nchk=nchk)
        for b in range(nbeam)
    ])
    rows = np.stack([
        np.ascontiguousarray(
            b.transpose(1, 3, 4, 0, 2, 5).reshape(nchk * 14, ndf, 256))
        for b in blocks
    ])
    mesh = M.make_beam_mesh(n_beam=2,
                            devices=jax.devices()[:2])
    spec = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(M.BEAM_AXIS))
    x = jax.device_put(jnp.asarray(rows), spec)

    # power (x tscrunch)
    step = S.make_multibeam_rows_step(mesh, nout=4)
    out = np.asarray(step(x))
    assert out.shape == (nbeam, 4, nchk * C.NCHAN_CHK)
    from paf_baseband2power_tpu.ops.golden import (
        baseband2power_scrunch_golden,
    )
    for b in range(nbeam):
        np.testing.assert_allclose(
            out[b], baseband2power_scrunch_golden(blocks[b], 4), rtol=1e-5)

    # Stokes
    sstep = S.make_multibeam_rows_step(mesh, nout=2, stokes=True)
    sout = np.asarray(sstep(x))
    assert sout.shape == (nbeam, 2, 4, nchk * C.NCHAN_CHK)
    for b in range(nbeam):
        want = baseband2stokes_scrunch_golden(blocks[b], 2)
        np.testing.assert_allclose(sout[b], want,
                                   rtol=1e-4,
                                   atol=1e-5 * np.abs(want).max())

    # fine channels
    pstep = S.make_multibeam_rows_step(mesh, nfft=128, nout=2, stokes=True)
    pout = np.asarray(pstep(x))
    assert pout.shape == (nbeam, 2, 4, nchk * C.NCHAN_CHK * 128)
    for b in range(nbeam):
        want = _pfb.pfb_spectra_golden(blocks[b], 128, 4, nout=2,
                                       stokes=True)
        np.testing.assert_allclose(pout[b], want, rtol=2e-4,
                                   atol=1e-5 * np.abs(want).max())


def test_sharded_rows_series_parity():
    """Series-sharded rows step: the chunk (TP) axis of the rows layout
    is collective-free for every detection mode."""
    from paf_baseband2power_tpu.ops import pfb as _pfb
    from paf_baseband2power_tpu.ops.frame import block_to_rows
    from paf_baseband2power_tpu.ops.golden import (
        baseband2power_scrunch_golden,
        baseband2stokes_golden,
    )

    ndf, nchk = 32, 4
    block = F.synthetic_block(rng=90, ndf=ndf, nchk=nchk)
    rows = block_to_rows(block)
    mesh = M.make_mesh(n_time=1, n_chunk=4,
                       devices=jax.devices()[:4])
    spec = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(M.CHUNK_AXIS))
    x = jax.device_put(jnp.asarray(rows), spec)

    step = S.make_sharded_rows_step(mesh, nout=4)
    out = np.asarray(step(x))
    np.testing.assert_allclose(
        out, baseband2power_scrunch_golden(block, 4), rtol=1e-5)

    sstep = S.make_sharded_rows_step(mesh, stokes=True)
    sout = np.asarray(sstep(x))
    want = baseband2stokes_golden(block)
    np.testing.assert_allclose(sout[0], want, rtol=1e-4,
                               atol=1e-5 * np.abs(want).max())

    pstep = S.make_sharded_rows_step(mesh, nfft=128, nout=2)
    pout = np.asarray(pstep(x))
    want = _pfb.pfb_spectra_golden(block, 128, 4, nout=2)
    np.testing.assert_allclose(pout, want, rtol=2e-4,
                               atol=1e-5 * np.abs(want).max())


def test_multibeam_rows_step_with_series_tp():
    """Beam-DP x series-TP composition: a (beam=2, chunk=2) mesh splits
    each beam's series over whole frequency chunks, zero collectives."""
    from paf_baseband2power_tpu.ops.frame import block_to_rows
    from paf_baseband2power_tpu.ops.golden import (
        baseband2power_scrunch_golden,
    )

    nbeam, ndf, nchk = 2, 32, 2
    blocks = np.stack([
        F.synthetic_block(rng=85 + b, ndf=ndf, nchk=nchk)
        for b in range(nbeam)
    ])
    rows = np.stack([block_to_rows(b) for b in blocks])
    mesh = M.make_beam_mesh(n_beam=2, n_chunk=2,
                            devices=jax.devices()[:4])
    spec = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(M.BEAM_AXIS, M.CHUNK_AXIS))
    x = jax.device_put(jnp.asarray(rows), spec)
    step = S.make_multibeam_rows_step(mesh, nout=4)
    out = np.asarray(step(x))
    assert out.shape == (nbeam, 4, nchk * C.NCHAN_CHK)
    for b in range(nbeam):
        np.testing.assert_allclose(
            out[b], baseband2power_scrunch_golden(blocks[b], 4),
            rtol=1e-5)


# ---------------------------------------------------------------------------
# Streaming carry across blocks (multi-device overlap-save continuity)
# ---------------------------------------------------------------------------

def test_sharded_pfb_streaming_continuity():
    """A 3-block stream on an 8-device (time x chunk) mesh sums to the
    one-shot golden over the concatenated series — the single-chip
    streaming property at any device count (VERDICT r4 missing #1)."""
    blocks = [F.synthetic_block(rng=100 + i, ndf=64, nchk=8)
              for i in range(3)]
    both = np.concatenate(blocks, axis=0)
    mesh = M.make_mesh(n_time=4, n_chunk=2)
    step = S.make_sharded_pfb_step(mesh, NFFT, NTAP, streaming=True)
    outs, h = [], None
    for b in blocks:
        o, h = step(S.shard_block(jnp.asarray(b), mesh), h)
        outs.append(np.asarray(o))
    want = _pfb.pfb_power_golden(both, NFFT, NTAP)
    np.testing.assert_allclose(sum(outs), want, rtol=2e-4)
    # carry equals the canonical edge-frame history of the last block
    ref = _pfb.pfb_history(jnp.asarray(blocks[-1]), NFFT, NTAP)
    np.testing.assert_allclose(np.asarray(h), np.asarray(ref), rtol=1e-6)


def test_sharded_pfb_streaming_single_time_shard():
    """n_time=1 (pure chunk TP): streaming still matches the golden."""
    blocks = [F.synthetic_block(rng=110 + i, ndf=32, nchk=8)
              for i in range(2)]
    both = np.concatenate(blocks, axis=0)
    mesh = M.make_mesh(n_time=1, n_chunk=8)
    step = S.make_sharded_pfb_step(mesh, NFFT, NTAP, streaming=True,
                                   mean=True)
    o1, h = step(S.shard_block(jnp.asarray(blocks[0]), mesh))
    o2, _ = step(S.shard_block(jnp.asarray(blocks[1]), mesh), h)
    # mean weights differ between the one-shot first block and the
    # streamed second; check against per-block unnormalized goldens
    nwin1 = 32 * C.NSAMP_DF // NFFT - (NTAP - 1)
    nwin2 = 32 * C.NSAMP_DF // NFFT
    total = np.asarray(o1) * (2 * nwin1) + np.asarray(o2) * (2 * nwin2)
    want = _pfb.pfb_power_golden(both, NFFT, NTAP)
    np.testing.assert_allclose(total, want, rtol=2e-4)


@pytest.mark.parametrize("nout,stokes", [(2, False), (2, True)])
def test_sharded_spectra_streaming_continuity(nout, stokes):
    """Composed fine-channel streaming on a (time=8) mesh: per-block
    waterfalls equal the concatenated golden's groups, group by group."""
    blocks = [F.synthetic_block(rng=120 + i, ndf=64, nchk=8)
              for i in range(2)]
    both = np.concatenate(blocks, axis=0)
    mesh = M.make_mesh(n_time=8)
    step = S.make_sharded_spectra_step(mesh, NFFT, NTAP, nout=nout,
                                       stokes=stokes, streaming=True)
    p1, h1 = step(S.shard_block(jnp.asarray(blocks[0]), mesh))
    p2, h2 = step(S.shard_block(jnp.asarray(blocks[1]), mesh), h1)
    want = _pfb.pfb_spectra_golden(both, NFFT, NTAP, nout=2 * nout,
                                   stokes=stokes)
    _spectra_close(np.asarray(p1), want[:nout])
    _spectra_close(np.asarray(p2), want[nout:])
    ref = _pfb.pfb_history(jnp.asarray(blocks[1]), NFFT, NTAP)
    np.testing.assert_allclose(np.asarray(h2), np.asarray(ref), rtol=1e-6)


def test_sharded_spectra_streaming_mean():
    """Streamed blocks use the full window count in every group's mean."""
    blocks = [F.synthetic_block(rng=130 + i, ndf=64, nchk=8)
              for i in range(2)]
    both = np.concatenate(blocks, axis=0)
    mesh = M.make_mesh(n_time=4, n_chunk=2)
    step = S.make_sharded_spectra_step(mesh, NFFT, NTAP, nout=2,
                                       stokes=True, mean=True,
                                       streaming=True)
    p1, h1 = step(S.shard_block(jnp.asarray(blocks[0]), mesh))
    p2, _ = step(S.shard_block(jnp.asarray(blocks[1]), mesh), h1)
    want = _pfb.pfb_spectra_golden(both, NFFT, NTAP, nout=4, stokes=True,
                                   mean=True)
    _spectra_close(np.asarray(p1), want[:2])
    _spectra_close(np.asarray(p2), want[2:])


def test_multibeam_pfb_2d_streaming():
    """Per-beam carries on the (beam, time, chunk) mesh."""
    nbeam, ndf = 2, 64
    mesh = M.make_beam_mesh(n_beam=2, n_time=2, n_chunk=2)
    b1 = np.stack([F.synthetic_block(rng=140 + b, ndf=ndf, nchk=8)
                   for b in range(nbeam)])
    b2 = np.stack([F.synthetic_block(rng=150 + b, ndf=ndf, nchk=8)
                   for b in range(nbeam)])
    spec = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(M.BEAM_AXIS, M.TIME_AXIS,
                                         M.CHUNK_AXIS))
    step = S.make_multibeam_pfb_step_2d(mesh, NFFT, NTAP, streaming=True)
    x1 = jax.device_put(jnp.asarray(b1.reshape(nbeam, ndf, -1)), spec)
    x2 = jax.device_put(jnp.asarray(b2.reshape(nbeam, ndf, -1)), spec)
    p1, h = step(x1)
    p2, h2 = step(x2, h)
    for b in range(nbeam):
        both = np.concatenate([b1[b], b2[b]], axis=0)
        want = _pfb.pfb_power_golden(both, NFFT, NTAP)
        np.testing.assert_allclose(
            np.asarray(p1[b]) + np.asarray(p2[b]), want, rtol=2e-4)
        ref = _pfb.pfb_history(jnp.asarray(b2[b]), NFFT, NTAP)
        np.testing.assert_allclose(np.asarray(h2[b]), np.asarray(ref),
                                   rtol=1e-6)


def test_multibeam_composed_2d_streaming():
    """Composed (PFB x Stokes x tscrunch) streaming across beams."""
    nbeam, ndf = 2, 64
    mesh = M.make_beam_mesh(n_beam=2, n_time=2, n_chunk=2)
    b1 = np.stack([F.synthetic_block(rng=160 + b, ndf=ndf, nchk=8)
                   for b in range(nbeam)])
    b2 = np.stack([F.synthetic_block(rng=170 + b, ndf=ndf, nchk=8)
                   for b in range(nbeam)])
    spec = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(M.BEAM_AXIS, M.TIME_AXIS,
                                         M.CHUNK_AXIS))
    step = S.make_multibeam_composed_step_2d(mesh, nfft=NFFT, ntap=NTAP,
                                             nout=2, stokes=True,
                                             streaming=True)
    p1, h = step(jax.device_put(jnp.asarray(b1.reshape(nbeam, ndf, -1)),
                                spec))
    p2, _ = step(jax.device_put(jnp.asarray(b2.reshape(nbeam, ndf, -1)),
                                spec), h)
    for b in range(nbeam):
        both = np.concatenate([b1[b], b2[b]], axis=0)
        want = _pfb.pfb_spectra_golden(both, NFFT, NTAP, nout=4,
                                       stokes=True)
        _spectra_close(np.asarray(p1[b]), want[:2])
        _spectra_close(np.asarray(p2[b]), want[2:])
    with pytest.raises(ValueError):
        S.make_multibeam_composed_step_2d(mesh, nout=2, streaming=True)


def test_sharded_rows_streaming():
    """Series-TP rows streaming: the raw int16 carry shards with its
    series — zero collectives, golden continuity."""
    from paf_baseband2power_tpu.ops.frame import block_to_rows

    ndf, nchk = 32, 4
    b1 = F.synthetic_block(rng=180, ndf=ndf, nchk=nchk)
    b2 = F.synthetic_block(rng=181, ndf=ndf, nchk=nchk)
    both = np.concatenate([b1, b2], axis=0)
    mesh = M.make_mesh(n_time=1, n_chunk=4, devices=jax.devices()[:4])
    spec = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(M.CHUNK_AXIS))
    step = S.make_sharded_rows_step(mesh, nfft=128, nout=2,
                                    streaming=True)
    p1, h = step(jax.device_put(jnp.asarray(block_to_rows(b1)), spec))
    p2, _ = step(jax.device_put(jnp.asarray(block_to_rows(b2)), spec), h)
    want = _pfb.pfb_spectra_golden(both, 128, 4, nout=4)
    _spectra_close(np.asarray(p1), want[:2])
    _spectra_close(np.asarray(p2), want[2:])
    with pytest.raises(ValueError):
        S.make_sharded_rows_step(mesh, nout=2, streaming=True)


def test_multibeam_rows_streaming():
    """Beam-DP x series-TP rows streaming with per-beam stacked carries."""
    from paf_baseband2power_tpu.ops.frame import block_to_rows

    nbeam, ndf, nchk = 2, 32, 2
    b1 = np.stack([F.synthetic_block(rng=190 + b, ndf=ndf, nchk=nchk)
                   for b in range(nbeam)])
    b2 = np.stack([F.synthetic_block(rng=195 + b, ndf=ndf, nchk=nchk)
                   for b in range(nbeam)])
    mesh = M.make_beam_mesh(n_beam=2, n_chunk=2, devices=jax.devices()[:4])
    spec = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(M.BEAM_AXIS, M.CHUNK_AXIS))
    step = S.make_multibeam_rows_step(mesh, nfft=128, nout=2, stokes=True,
                                      streaming=True)
    x1 = jax.device_put(jnp.asarray(np.stack([block_to_rows(b)
                                              for b in b1])), spec)
    x2 = jax.device_put(jnp.asarray(np.stack([block_to_rows(b)
                                              for b in b2])), spec)
    p1, h = step(x1)
    assert h.shape == (nbeam, nchk * 14, 3, 256)
    p2, _ = step(x2, h)
    for b in range(nbeam):
        both = np.concatenate([b1[b], b2[b]], axis=0)
        want = _pfb.pfb_spectra_golden(both, 128, 4, nout=4, stokes=True)
        _spectra_close(np.asarray(p1[b]), want[:2])
        _spectra_close(np.asarray(p2[b]), want[2:])


@pytest.mark.parametrize("stokes", [False, True])
def test_sharded_spectra_scatter_output(pfb_block, stokes):
    """reduce_scatter output mode: the spectra axis comes back sharded
    over time (each shard owns nout/n_time groups), numerically identical
    to the allreduce form."""
    mesh = M.make_mesh(n_time=4, n_chunk=2)
    step = S.make_sharded_spectra_step(mesh, NFFT, NTAP, nout=8,
                                       stokes=stokes, mean=True,
                                       scatter_output=True)
    out = step(S.shard_block(jnp.asarray(pfb_block), mesh))
    # output sharded P(time, [None,] chunk) on the spectra axis
    want_spec = (jax.sharding.PartitionSpec(M.TIME_AXIS, None, M.CHUNK_AXIS)
                 if stokes else
                 jax.sharding.PartitionSpec(M.TIME_AXIS, M.CHUNK_AXIS))
    assert out.sharding.spec == want_spec
    want = _pfb.pfb_spectra_golden(pfb_block, NFFT, NTAP, nout=8,
                                   stokes=stokes, mean=True)
    _spectra_close(np.asarray(out), want)
    with pytest.raises(ValueError):
        S.make_sharded_spectra_step(mesh, NFFT, NTAP, nout=6,
                                    scatter_output=True)


def test_sharded_spectra_scatter_streaming(pfb_block):
    """Scatter output composes with the streaming carry."""
    b2 = F.synthetic_block(rng=200, ndf=64, nchk=8)
    both = np.concatenate([pfb_block, b2], axis=0)
    mesh = M.make_mesh(n_time=8)
    step = S.make_sharded_spectra_step(mesh, NFFT, NTAP, nout=8,
                                       streaming=True, scatter_output=True)
    p1, h = step(S.shard_block(jnp.asarray(pfb_block), mesh))
    p2, _ = step(S.shard_block(jnp.asarray(b2), mesh), h)
    want = _pfb.pfb_spectra_golden(both, NFFT, NTAP, nout=16)
    _spectra_close(np.asarray(p1), want[:8])
    _spectra_close(np.asarray(p2), want[8:])


def test_multibeam_composed_scatter_output():
    """Multibeam scatter: per-beam waterfalls come back time-sharded on
    the spectra axis, golden-identical to the allreduce form."""
    nbeam, ndf = 2, 64
    mesh = M.make_beam_mesh(n_beam=2, n_time=2, n_chunk=2)
    blocks = np.stack([F.synthetic_block(rng=210 + b, ndf=ndf, nchk=8)
                       for b in range(nbeam)])
    spec = jax.sharding.NamedSharding(
        mesh, jax.sharding.PartitionSpec(M.BEAM_AXIS, M.TIME_AXIS,
                                         M.CHUNK_AXIS))
    step = S.make_multibeam_composed_step_2d(
        mesh, nfft=NFFT, ntap=NTAP, nout=4, stokes=True,
        scatter_output=True)
    out = step(jax.device_put(jnp.asarray(blocks.reshape(nbeam, ndf, -1)),
                              spec))
    assert out.sharding.spec == jax.sharding.PartitionSpec(
        M.BEAM_AXIS, M.TIME_AXIS, None, M.CHUNK_AXIS)
    for b in range(nbeam):
        want = _pfb.pfb_spectra_golden(blocks[b], NFFT, NTAP, nout=4,
                                       stokes=True)
        _spectra_close(np.asarray(out[b]), want)
    with pytest.raises(ValueError):
        S.make_multibeam_composed_step_2d(mesh, nout=4, stokes=True,
                                          scatter_output=True)
