"""Composed fine-channel detection: PFB x tscrunch waterfall, PFB x Stokes.

Parity chain: float64 golden (pfb_spectra_golden) -> XLA (pfb_spectra) on
the wire layout and on series rows. Reference contract: the planned cuFFT channelizer
(/root/reference/makefile:27, kernel.cuh:4-7) composed with the detect-and-
average usage string (paf_baseband2power.cu:20).
"""

import numpy as np
import pytest

import jax.numpy as jnp

from paf_baseband2power_tpu import constants as C
from paf_baseband2power_tpu.ops import frame as F
from paf_baseband2power_tpu.ops import pfb

NDF, NCHK, NFFT, NTAP = 16, 2, 32, 4


def assert_close(got, want, rtol=2e-4):
    """Scale-aware parity: Q/U/V of noise sit near zero by cancellation, so
    absolute error is bounded by the detection scale (I), not the value."""
    atol = 1e-5 * float(np.abs(want).max())
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol)


# --------------------------------------------------------------------------
# Golden self-consistency
# --------------------------------------------------------------------------

def test_golden_nout1_equals_pfb_power_golden():
    block = F.synthetic_block(rng=50, ndf=NDF, nchk=NCHK)
    got = pfb.pfb_spectra_golden(block, NFFT, NTAP, nout=1)
    want = pfb.pfb_power_golden(block, NFFT, NTAP)
    assert got.shape == (1, NCHK * C.NCHAN_CHK * NFFT)
    np.testing.assert_allclose(got[0], want, rtol=1e-6)


def test_golden_waterfall_partitions_total_power():
    """Summing the waterfall over spectra recovers the one-shot total."""
    block = F.synthetic_block(rng=51, ndf=NDF, nchk=NCHK)
    wf = pfb.pfb_spectra_golden(block, NFFT, NTAP, nout=4)
    total = pfb.pfb_power_golden(block, NFFT, NTAP)
    assert wf.shape == (4, NCHK * C.NCHAN_CHK * NFFT)
    np.testing.assert_allclose(wf.sum(axis=0), total, rtol=1e-6)


def test_golden_stokes_I_equals_power():
    block = F.synthetic_block(rng=52, ndf=NDF, nchk=NCHK)
    s = pfb.pfb_spectra_golden(block, NFFT, NTAP, stokes=True)
    assert s.shape == (1, 4, NCHK * C.NCHAN_CHK * NFFT)
    total = pfb.pfb_power_golden(block, NFFT, NTAP)
    np.testing.assert_allclose(s[0, 0], total, rtol=1e-6)


def test_golden_stokes_polarized_tone():
    """A pure-x tone gives Q = I, U = V = 0 in its fine channel."""
    nsamp = NDF * C.NSAMP_DF
    n = np.arange(nsamp)
    tone = 100.0 * np.exp(2j * np.pi * 5 * n / NFFT)
    block = np.zeros((NDF, NCHK, C.NSAMP_DF, C.NCHAN_CHK, 2, 2), np.int16)
    series = tone.reshape(NDF, C.NSAMP_DF)
    block[:, 1, :, 3, 0, 0] = np.round(series.real)
    block[:, 1, :, 3, 0, 1] = np.round(series.imag)
    s = pfb.pfb_spectra_golden(block, NFFT, NTAP, stokes=True)[0]
    grid = s.reshape(4, NCHK, C.NCHAN_CHK, NFFT)
    hot = grid[:, 1, 3, (5 + NFFT // 2) % NFFT]
    assert hot[0] > 1e3
    np.testing.assert_allclose(hot[1], hot[0], rtol=1e-9)   # Q == I
    assert abs(hot[2]) < 1e-6 * hot[0] and abs(hot[3]) < 1e-6 * hot[0]


def test_golden_validation():
    block = F.synthetic_block(rng=53, ndf=NDF, nchk=NCHK)
    with pytest.raises(ValueError):
        pfb.pfb_spectra_golden(block, NFFT, NTAP, nout=7)   # not a divisor
    with pytest.raises(ValueError):                          # wpg < ntap-1
        pfb.pfb_spectra_golden(block, NFFT, NTAP,
                               nout=NDF * C.NSAMP_DF // NFFT)


# --------------------------------------------------------------------------
# XLA path parity
# --------------------------------------------------------------------------

@pytest.mark.parametrize("nout,stokes", [(1, False), (4, False), (1, True),
                                         (8, True)])
@pytest.mark.parametrize("method", ["matmul", "fft"])
def test_xla_spectra_matches_golden(nout, stokes, method):
    block = F.synthetic_block(rng=60, ndf=NDF, nchk=NCHK)
    got = np.asarray(pfb.pfb_spectra(jnp.asarray(block), NFFT, NTAP,
                                     nout=nout, stokes=stokes,
                                     method=method))
    want = pfb.pfb_spectra_golden(block, NFFT, NTAP, nout=nout,
                                  stokes=stokes)
    assert_close(got, want)


def test_xla_spectra_mean_noshift():
    block = F.synthetic_block(rng=61, ndf=NDF, nchk=NCHK)
    for stokes in (False, True):
        got = np.asarray(pfb.pfb_spectra(jnp.asarray(block), NFFT, NTAP,
                                         nout=4, stokes=stokes, mean=True,
                                         shift=False))
        want = pfb.pfb_spectra_golden(block, NFFT, NTAP, nout=4,
                                      stokes=stokes, mean=True, shift=False)
        assert_close(got, want)


def test_xla_spectra_chunk_groups_identical():
    block = F.synthetic_block(rng=62, ndf=NDF, nchk=4)
    mono = np.asarray(pfb.pfb_spectra(jnp.asarray(block), NFFT, NTAP,
                                      nout=4, stokes=True, chunk_groups=1))
    grp = np.asarray(pfb.pfb_spectra(jnp.asarray(block), NFFT, NTAP,
                                     nout=4, stokes=True, chunk_groups=4))
    np.testing.assert_allclose(grp, mono, rtol=1e-6)


@pytest.mark.parametrize("nout,stokes", [(2, False), (2, True)])
def test_xla_spectra_streaming_continuity(nout, stokes):
    """Two blocks with history == one-shot golden over the concatenation,
    group by group (the end-row window convention)."""
    b1 = F.synthetic_block(rng=63, ndf=NDF, nchk=NCHK)
    b2 = F.synthetic_block(rng=64, ndf=NDF, nchk=NCHK)
    both = np.concatenate([b1, b2], axis=0)
    step = pfb.make_streaming_spectra(NFFT, NTAP, nout=nout, stokes=stokes,
                                      method="matmul")
    p1, h1 = step(jnp.asarray(b1), None)
    p2, h2 = step(jnp.asarray(b2), h1)
    want = pfb.pfb_spectra_golden(both, NFFT, NTAP, nout=2 * nout,
                                  stokes=stokes)
    assert_close(np.asarray(p1), want[:nout])
    assert_close(np.asarray(p2), want[nout:])
    # carry equals the canonical edge-frame history
    ref = pfb.pfb_history(jnp.asarray(b2), NFFT, NTAP)
    np.testing.assert_allclose(np.asarray(h2), np.asarray(ref))


def test_streaming_spectra_accepts_2d_layout():
    block = F.synthetic_block(rng=65, ndf=NDF, nchk=NCHK)
    step = pfb.make_streaming_spectra(NFFT, NTAP, nout=4, method="matmul")
    a, _ = step(jnp.asarray(block), None)
    b, _ = step(jnp.asarray(block.reshape(NDF, -1)), None)
    np.testing.assert_allclose(np.asarray(a), np.asarray(b))


# --------------------------------------------------------------------------
# The production nfft sizes (128 ... 1024), auto method
# --------------------------------------------------------------------------

@pytest.mark.parametrize("nout,stokes", [(1, False), (2, False), (1, True),
                                         (2, True)])
def test_xla_spectra_128_matches_golden(nout, stokes):
    block = F.synthetic_block(rng=70, ndf=32, nchk=NCHK)
    got = np.asarray(pfb.pfb_spectra(jnp.asarray(block), 128, NTAP,
                                     nout=nout, stokes=stokes))
    want = pfb.pfb_spectra_golden(block, 128, NTAP, nout=nout, stokes=stokes)
    assert_close(got, want)


@pytest.mark.parametrize("nfft,ndf", [(256, 16), (512, 32), (1024, 64)])
def test_xla_spectra_large_nfft_matches_golden(nfft, ndf):
    """Stacked matmul (256) and grouped fft (512, 1024) vs the golden."""
    block = F.synthetic_block(rng=71, ndf=ndf, nchk=1)
    got = np.asarray(pfb.pfb_spectra(jnp.asarray(block), nfft, NTAP))
    want = pfb.pfb_spectra_golden(block, nfft, NTAP)
    assert_close(got, want)


def test_xla_spectra_large_nfft_stokes_waterfall():
    block = F.synthetic_block(rng=72, ndf=32, nchk=1)
    got = np.asarray(pfb.pfb_spectra(jnp.asarray(block), 256, NTAP,
                                     nout=2, stokes=True))
    want = pfb.pfb_spectra_golden(block, 256, NTAP, nout=2, stokes=True)
    assert_close(got, want)


def test_xla_spectra_tone_localization_1024():
    """A tone at fine channel k0 of a 1024-channelizer lands at k0 (after
    the fftshift) in both layouts."""
    nfft, ndf, k0 = 1024, 64, 137
    nsamp = ndf * C.NSAMP_DF
    n = np.arange(nsamp)
    tone = 100.0 * np.exp(2j * np.pi * k0 * n / nfft)
    block = np.zeros((ndf, 1, C.NSAMP_DF, C.NCHAN_CHK, 2, 2), np.int16)
    series = tone.reshape(ndf, C.NSAMP_DF)
    block[:, 0, :, 2, 0, 0] = np.round(series.real)
    block[:, 0, :, 2, 0, 1] = np.round(series.imag)
    for x, layout in ((block, "wire"), (F.block_to_rows(block), "rows")):
        got = np.asarray(pfb.pfb_spectra(jnp.asarray(x), nfft, NTAP,
                                         layout=layout))
        grid = got.reshape(1, C.NCHAN_CHK, nfft)
        hot = grid[0, 2]
        assert int(hot.argmax()) == (k0 + nfft // 2) % nfft
        assert grid.sum() - hot.sum() < 1e-5 * hot.sum()


@pytest.mark.parametrize("nfft,ndf,stokes", [(128, 32, False),
                                             (256, 16, True)])
def test_xla_spectra_rows_streaming_continuity(nfft, ndf, stokes):
    """Rows layout over 2 blocks: the raw int16 rows carry gives the
    one-shot golden over the concatenation, group by group."""
    b1 = F.synthetic_block(rng=73, ndf=ndf, nchk=NCHK)
    b2 = F.synthetic_block(rng=74, ndf=ndf, nchk=NCHK)
    both = np.concatenate([b1, b2], axis=0)
    step = pfb.make_streaming_spectra(nfft, NTAP, stokes=stokes,
                                      layout="rows")
    p1, h1 = step(jnp.asarray(F.block_to_rows(b1)), None)
    p2, h2 = step(jnp.asarray(F.block_to_rows(b2)), h1)
    assert h2.dtype == jnp.int16
    want = pfb.pfb_spectra_golden(both, nfft, NTAP, nout=2, stokes=stokes)
    assert_close(np.asarray(p1), want[:1])
    assert_close(np.asarray(p2), want[1:])
    ref = pfb.pfb_history(jnp.asarray(b2), nfft, NTAP)
    np.testing.assert_allclose(
        np.asarray(pfb.history_as_complex(h2, NTAP, nfft)), np.asarray(ref))


def test_xla_spectra_mean_2d_layout_agrees():
    block = F.synthetic_block(rng=75, ndf=32, nchk=NCHK)
    a = np.asarray(pfb.pfb_spectra(jnp.asarray(block), 128, NTAP, nout=2,
                                   stokes=True, mean=True))
    b = np.asarray(pfb.pfb_spectra(jnp.asarray(block), 128, NTAP, nout=2,
                                   stokes=True, mean=True, method="fft"))
    np.testing.assert_allclose(a, b, rtol=2e-4,
                               atol=1e-5 * float(np.abs(b).max()))
    c = np.asarray(pfb.pfb_spectra(jnp.asarray(block.reshape(32, -1)),
                                   128, NTAP, nout=2, stokes=True, mean=True))
    np.testing.assert_allclose(a, c)


def test_xla_spectra_validation():
    block = jnp.asarray(F.synthetic_block(rng=76, ndf=32, nchk=1))
    with pytest.raises(ValueError):
        pfb.pfb_spectra(block, 128, nout=3)              # not a divisor
    with pytest.raises(ValueError):
        pfb.pfb_spectra(block, 128, nout=16)             # wpg < ntap-1
    with pytest.raises(ValueError):
        pfb.pfb_spectra(block, 128, layout="bogus")
    with pytest.raises(ValueError):                      # wire as rows
        pfb.pfb_spectra(block.reshape(32, -1), 128, layout="rows")


def test_xla_spectra_high_nout_waterfall():
    """High-nout waterfall (8 spectra of 4 windows each)."""
    block = F.synthetic_block(rng=77, ndf=64, nchk=1)
    for stokes in (False, True):
        got = np.asarray(pfb.pfb_spectra(jnp.asarray(block), 128, NTAP,
                                         nout=8, stokes=stokes))
        want = pfb.pfb_spectra_golden(block, 128, NTAP, nout=8,
                                      stokes=stokes)
        assert_close(got, want)


# --------------------------------------------------------------------------
# Non-PFB Stokes x tscrunch composition (coarse channels)
# --------------------------------------------------------------------------

def test_stokes_scrunch_golden_and_xla():
    from paf_baseband2power_tpu.ops.golden import (
        baseband2stokes_golden,
        baseband2stokes_scrunch_golden,
    )
    from paf_baseband2power_tpu.ops.power import baseband2stokes_scrunch_2d

    block = F.synthetic_block(rng=80, ndf=16, nchk=NCHK)
    want = baseband2stokes_scrunch_golden(block, 4)
    assert want.shape == (4, 4, NCHK * C.NCHAN_CHK)
    # nout=1 equals plain Stokes
    np.testing.assert_allclose(
        baseband2stokes_scrunch_golden(block, 1)[0],
        baseband2stokes_golden(block), rtol=1e-6)
    got = np.asarray(baseband2stokes_scrunch_2d(
        jnp.asarray(block.reshape(16, -1)), 4))
    assert_close(got, want, rtol=1e-4)
    got_m = np.asarray(baseband2stokes_scrunch_2d(
        jnp.asarray(block.reshape(16, -1)), 4, mean=True))
    want_m = baseband2stokes_scrunch_golden(block, 4, mean=True)
    assert_close(got_m, want_m, rtol=1e-4)


def test_stokes_scrunch_2d_short_windows():
    from paf_baseband2power_tpu.ops.golden import (
        baseband2stokes_scrunch_golden,
    )
    from paf_baseband2power_tpu.ops.power import baseband2stokes_scrunch_2d

    block = F.synthetic_block(rng=81, ndf=32, nchk=NCHK)
    for nout, mean in ((2, False), (8, True)):
        got = np.asarray(baseband2stokes_scrunch_2d(
            jnp.asarray(block.reshape(32, -1)), nout, mean=mean))
        want = baseband2stokes_scrunch_golden(block, nout, mean=mean)
        assert_close(got, want, rtol=1e-4)
    with pytest.raises(ValueError):
        baseband2stokes_scrunch_2d(jnp.asarray(block.reshape(32, -1)),
                                   3)  # 3 does not divide 32 frames


def test_mean_zero_window_group_is_zero_not_nan():
    """wpg == ntap-1 leaves spectrum 0 with zero windows one-shot; mean
    mode must yield 0 there, not 0/0 = NaN (regression)."""
    block = F.synthetic_block(rng=90, ndf=12, nchk=1)
    # nfft=32 -> nblk=48 slots; nout=16 -> wpg=3 == ntap-1
    want = pfb.pfb_spectra_golden(block, 32, 4, nout=16, mean=True)
    assert np.isfinite(want).all()
    assert np.all(want[0] == 0.0)
    got = np.asarray(pfb.pfb_spectra(jnp.asarray(block), 32, 4, nout=16,
                                     mean=True))
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, rtol=2e-4,
                               atol=1e-5 * np.abs(want).max())


def test_streaming_factories_take_both_layouts():
    """One step object per mode x layout: the factories forward ``layout``
    and the rows step returns the raw int16 carry, the wire step the
    complex series carry."""
    block = F.synthetic_block(rng=78, ndf=32, nchk=NCHK)
    for layout, x in (("wire", block), ("rows", F.block_to_rows(block))):
        _, hs = pfb.make_streaming_spectra(128, NTAP, nout=2,
                                           layout=layout)(jnp.asarray(x),
                                                          None)
        _, hp = pfb.make_streaming_pfb(128, NTAP, layout=layout)(
            jnp.asarray(x), None)
        want = jnp.int16 if layout == "rows" else jnp.complex64
        assert hs.dtype == want and hp.dtype == want
        assert hs.shape == hp.shape


# --------------------------------------------------------------------------
# Device-layout (host corner turn) consumption
# --------------------------------------------------------------------------

def _to_rows(block):
    ndf = block.shape[0]
    nchk = block.shape[1]
    return (block.transpose(1, 3, 4, 0, 2, 5)
            .reshape(nchk * 14, ndf, 256))


def test_xla_spectra_rows_layout_matches_wire():
    block = F.synthetic_block(rng=95, ndf=32, nchk=NCHK)
    rows = _to_rows(block)
    for nout, stokes in ((1, False), (2, True)):
        a = np.asarray(pfb.pfb_spectra(jnp.asarray(block), 128, NTAP,
                                       nout=nout, stokes=stokes))
        b = np.asarray(pfb.pfb_spectra(jnp.asarray(rows), 128, NTAP,
                                       nout=nout, stokes=stokes,
                                       layout="rows"))
        np.testing.assert_allclose(b, a, rtol=1e-6)
        # 2-D flattened rows too
        c = np.asarray(pfb.pfb_spectra(
            jnp.asarray(rows.reshape(NCHK * 14, -1)), 128, NTAP, nout=nout,
            stokes=stokes, layout="rows"))
        np.testing.assert_allclose(c, a, rtol=1e-6)


def test_xla_spectra_rows_streaming_history():
    b1 = F.synthetic_block(rng=96, ndf=32, nchk=NCHK)
    b2 = F.synthetic_block(rng=97, ndf=32, nchk=NCHK)
    both = np.concatenate([b1, b2], axis=0)
    p1, h1 = pfb.pfb_spectra(jnp.asarray(_to_rows(b1)), 128, NTAP,
                             layout="rows", return_history=True)
    p2, h2 = pfb.pfb_spectra(jnp.asarray(_to_rows(b2)), 128, NTAP,
                             history=h1, layout="rows", return_history=True)
    assert h1.shape == (NCHK * 14, 3, 256)
    want = pfb.pfb_spectra_golden(both, 128, NTAP, nout=2)
    assert_close(np.asarray(p1), want[:1])
    assert_close(np.asarray(p2), want[1:])
    ref = pfb.pfb_history(jnp.asarray(b2), 128, NTAP)
    np.testing.assert_allclose(
        np.asarray(pfb.history_as_complex(h2, NTAP, 128)), np.asarray(ref))


def test_power_scrunch_rows_matches_golden():
    from paf_baseband2power_tpu.ops.golden import (
        baseband2power_golden,
        baseband2power_scrunch_golden,
    )
    from paf_baseband2power_tpu.ops.power import baseband2power_scrunch_rows

    block = F.synthetic_block(rng=98, ndf=16, nchk=NCHK)
    rows2d = jnp.asarray(_to_rows(block).reshape(NCHK * 14, -1))
    got1 = np.asarray(baseband2power_scrunch_rows(rows2d, 1))
    np.testing.assert_allclose(got1[0], baseband2power_golden(block),
                               rtol=1e-5)
    got4 = np.asarray(baseband2power_scrunch_rows(rows2d, 4, mean=True))
    want4 = baseband2power_scrunch_golden(block, 4, mean=True)
    np.testing.assert_allclose(got4, want4, rtol=1e-5)


@pytest.mark.parametrize("nout", [1, 2, 8])
def test_stokes_rows_matches_golden(nout):
    """Rows-layout Stokes (x tscrunch): adjacent x/y series rows,
    interleaved re/im lanes, vs the wire-block golden."""
    from paf_baseband2power_tpu.ops.golden import (
        baseband2stokes_scrunch_golden,
    )
    from paf_baseband2power_tpu.ops.power import baseband2stokes_scrunch_rows

    block = F.synthetic_block(rng=105, ndf=32, nchk=NCHK)
    rows2d = jnp.asarray(_to_rows(block).reshape(NCHK * 14, -1))
    for mean in (False, True):
        got = np.asarray(baseband2stokes_scrunch_rows(rows2d, nout,
                                                      mean=mean))
        want = baseband2stokes_scrunch_golden(block, nout, mean=mean)
        assert got.shape == (nout, 4, NCHK * C.NCHAN_CHK)
        assert_close(got, want, rtol=1e-4)


def test_power_rows_3d_matches_golden():
    """Rows-layout power (x tscrunch) on the 3-D device form, and the 2-D
    flattening gives the same records."""
    from paf_baseband2power_tpu.ops.golden import (
        baseband2power_golden,
        baseband2power_scrunch_golden,
    )
    from paf_baseband2power_tpu.ops.power import baseband2power_scrunch_rows

    block = F.synthetic_block(rng=121, ndf=32, nchk=4)
    rows3 = jnp.asarray(_to_rows(block))
    got1 = np.asarray(baseband2power_scrunch_rows(rows3, 1))
    np.testing.assert_allclose(got1[0], baseband2power_golden(block),
                               rtol=1e-5)
    got4 = np.asarray(baseband2power_scrunch_rows(rows3, 4, mean=True))
    want4 = baseband2power_scrunch_golden(block, 4, mean=True)
    np.testing.assert_allclose(got4, want4, rtol=1e-5)
    got2d = np.asarray(baseband2power_scrunch_rows(
        jnp.asarray(_to_rows(block).reshape(4 * 14, -1)), 1))
    np.testing.assert_allclose(got2d, got1)
    with pytest.raises(ValueError):
        baseband2power_scrunch_rows(rows3, 3)     # 3 does not divide 32
