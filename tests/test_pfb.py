"""PFB channelizer tests: golden parity, tone localization, streaming."""

import numpy as np
import pytest

import jax.numpy as jnp

from paf_baseband2power_tpu import constants as C
from paf_baseband2power_tpu.ops import frame as F
from paf_baseband2power_tpu.ops import pfb

NDF, NCHK, NFFT, NTAP = 16, 2, 32, 4


def make_tone_block(ndf, nchk, k0=5, chunk=1, chan=3, amp=100.0):
    """Block with a complex tone at fine channel k0 of one coarse channel."""
    nsamp = ndf * C.NSAMP_DF
    n = np.arange(nsamp)
    tone = amp * np.exp(2j * np.pi * k0 * n / NFFT)
    block = np.zeros((ndf, nchk, C.NSAMP_DF, C.NCHAN_CHK, 2, 2), np.int16)
    series = tone.reshape(ndf, C.NSAMP_DF)
    for p in range(2):
        block[:, chunk, :, chan, p, 0] = np.round(series.real)
        block[:, chunk, :, chan, p, 1] = np.round(series.imag)
    return block


def test_coeffs_shape_and_dc_gain():
    h = pfb.pfb_coeffs(NFFT, NTAP)
    assert h.shape == (NTAP, NFFT)
    # unit average DC gain across phases
    np.testing.assert_allclose(h.sum(axis=0).mean(), 1.0, rtol=1e-6)
    with pytest.raises(ValueError):
        pfb.pfb_coeffs(NFFT, NTAP, window="bogus")


def test_pfb_power_matches_golden():
    block = F.synthetic_block(rng=17, ndf=NDF, nchk=NCHK)
    got = np.asarray(pfb.pfb_power(jnp.asarray(block), NFFT, NTAP))
    want = pfb.pfb_power_golden(block, NFFT, NTAP)
    assert got.shape == (NCHK * C.NCHAN_CHK * NFFT,)
    np.testing.assert_allclose(got, want, rtol=2e-4)


def test_pfb_mean_and_noshift_match_golden():
    block = F.synthetic_block(rng=18, ndf=NDF, nchk=NCHK)
    got = np.asarray(pfb.pfb_power(jnp.asarray(block), NFFT, NTAP,
                                   mean=True, shift=False))
    want = pfb.pfb_power_golden(block, NFFT, NTAP, mean=True, shift=False)
    np.testing.assert_allclose(got, want, rtol=2e-4)


def test_tone_lands_in_right_fine_channel():
    k0, chunk, chan = 5, 1, 3
    block = make_tone_block(NDF, NCHK, k0=k0, chunk=chunk, chan=chan)
    power = np.asarray(pfb.pfb_power(jnp.asarray(block), NFFT, NTAP))
    grid = power.reshape(NCHK, C.NCHAN_CHK, NFFT)
    # all energy in the driven coarse channel
    hot = grid[chunk, chan]
    others = grid.sum() - hot.sum()
    assert hot.sum() > 1e3
    assert others < 1e-6 * hot.sum()
    # fine-channel peak at fftshifted k0
    expect_idx = (k0 + NFFT // 2) % NFFT
    assert int(hot.argmax()) == expect_idx
    # selectivity: peak dominates
    assert hot[expect_idx] > 100 * np.median(hot + 1e-9)


def test_streaming_history_continuity():
    """Two blocks with history == one concatenated double block."""
    b1 = F.synthetic_block(rng=20, ndf=NDF, nchk=NCHK)
    b2 = F.synthetic_block(rng=21, ndf=NDF, nchk=NCHK)
    both = np.concatenate([b1, b2], axis=0)

    step = pfb.make_streaming_pfb(NFFT, NTAP)
    p1, h1 = step(jnp.asarray(b1), None)
    p2, _ = step(jnp.asarray(b2), h1)
    total_streamed = np.asarray(p1) + np.asarray(p2)

    want = pfb.pfb_power_golden(both, NFFT, NTAP)
    np.testing.assert_allclose(total_streamed, want, rtol=2e-4)


def test_history_shape():
    block = F.synthetic_block(rng=22, ndf=NDF, nchk=NCHK)
    h = np.asarray(pfb.pfb_history(jnp.asarray(block), NFFT, NTAP))
    assert h.shape == (NCHK, C.NCHAN_CHK, 2, (NTAP - 1) * NFFT)
    assert h.dtype == np.complex64


def test_single_tap_is_weighted_segment_fft():
    """ntap=1 PFB == FFT of prototype-weighted nfft segments."""
    block = F.synthetic_block(rng=23, ndf=8, nchk=1)
    got = np.asarray(pfb.pfb_power(jnp.asarray(block), NFFT, ntap=1,
                                   window="rect", shift=False))
    h = pfb.pfb_coeffs(NFFT, 1, "rect", dtype=np.float64)[0]
    v = block.astype(np.float64)
    series = (v[..., 0] + 1j * v[..., 1]).transpose(1, 3, 4, 0, 2).reshape(
        1, C.NCHAN_CHK, 2, -1)
    segs = series.reshape(1, C.NCHAN_CHK, 2, -1, NFFT) * h
    want = (np.abs(np.fft.fft(segs, axis=-1)) ** 2).sum(axis=(2, 3))
    np.testing.assert_allclose(got, want.reshape(-1), rtol=2e-4)


def test_chunk_grouped_matches_monolithic():
    """lax.map chunk grouping is numerically identical to one-shot."""
    block = F.synthetic_block(rng=25, ndf=NDF, nchk=8)
    mono = np.asarray(pfb.pfb_power(jnp.asarray(block), NFFT, NTAP))
    grouped = np.asarray(pfb.pfb_power(jnp.asarray(block), NFFT, NTAP,
                                       chunk_groups=4))
    np.testing.assert_allclose(grouped, mono, rtol=1e-6)
    # with history too
    h = pfb.pfb_history(jnp.asarray(block), NFFT, NTAP)
    mono_h = np.asarray(pfb.pfb_power(jnp.asarray(block), NFFT, NTAP,
                                      history=h))
    grp_h = np.asarray(pfb.pfb_power(jnp.asarray(block), NFFT, NTAP,
                                     history=h, chunk_groups=2))
    np.testing.assert_allclose(grp_h, mono_h, rtol=1e-6)


@pytest.mark.parametrize("nfft,ntap", [(16, 4), (32, 4), (32, 8), (64, 3),
                                       (128, 4), (128, 3), (256, 2)])
def test_matmul_method_matches_golden(nfft, ntap):
    """Matmul channelizer (sliding when 128%nfft==0, stacked otherwise)."""
    block = F.synthetic_block(rng=30, ndf=NDF, nchk=NCHK)
    got = np.asarray(pfb.pfb_power(jnp.asarray(block), nfft, ntap,
                                   method="matmul"))
    want = pfb.pfb_power_golden(block, nfft, ntap)
    np.testing.assert_allclose(got, want, rtol=2e-4)


def test_fft_and_matmul_methods_agree():
    block = F.synthetic_block(rng=31, ndf=NDF, nchk=NCHK)
    a = np.asarray(pfb.pfb_power(jnp.asarray(block), NFFT, NTAP,
                                 method="fft"))
    b = np.asarray(pfb.pfb_power(jnp.asarray(block), NFFT, NTAP,
                                 method="matmul"))
    np.testing.assert_allclose(a, b, rtol=1e-5)
    with pytest.raises(ValueError):
        pfb.pfb_power(jnp.asarray(block), NFFT, NTAP, method="bogus")


def test_matmul_streaming_history_continuity():
    """Sliding path: two blocks with history == one double block."""
    b1 = F.synthetic_block(rng=32, ndf=NDF, nchk=NCHK)
    b2 = F.synthetic_block(rng=33, ndf=NDF, nchk=NCHK)
    both = np.concatenate([b1, b2], axis=0)
    step = pfb.make_streaming_pfb(NFFT, NTAP, method="matmul")
    p1, h1 = step(jnp.asarray(b1), None)
    p2, h2 = step(jnp.asarray(b2), h1)
    total = np.asarray(p1) + np.asarray(p2)
    want = pfb.pfb_power_golden(both, NFFT, NTAP)
    np.testing.assert_allclose(total, want, rtol=2e-4)
    # the sliding path's edge-frame carry == the full-series carry
    ref = pfb.pfb_history(jnp.asarray(b2), NFFT, NTAP)
    np.testing.assert_allclose(np.asarray(jnp.real(h2)),
                               np.asarray(jnp.real(ref)), rtol=1e-6)
    np.testing.assert_allclose(np.asarray(jnp.imag(h2)),
                               np.asarray(jnp.imag(ref)), rtol=1e-6)


def test_sliding_mats_structure():
    mats = pfb.pfb_sliding_mats(NFFT, NTAP)
    L = 128
    d_expect = 1 + -(-((NTAP - 1) * NFFT) // L)
    assert mats.shape == (d_expect, 2 * L, 2 * L)
    # real/imag block symmetry: M = [[Wre, Wim], [-Wim, Wre]]
    np.testing.assert_allclose(mats[:, :L, :L], mats[:, L:, L:], atol=0)
    np.testing.assert_allclose(mats[:, L:, :L], -mats[:, :L, L:], atol=0)
    with pytest.raises(ValueError):
        pfb.pfb_sliding_mats(48, NTAP)  # 128 % 48 != 0


def test_matmul_tone_localization():
    k0, chunk, chan = 5, 1, 3
    block = make_tone_block(NDF, NCHK, k0=k0, chunk=chunk, chan=chan)
    power = np.asarray(pfb.pfb_power(jnp.asarray(block), NFFT, NTAP,
                                     method="matmul"))
    grid = power.reshape(NCHK, C.NCHAN_CHK, NFFT)
    hot = grid[chunk, chan]
    assert int(hot.argmax()) == (k0 + NFFT // 2) % NFFT
    assert grid.sum() - hot.sum() < 1e-6 * hot.sum()


def test_default_chunk_groups():
    # sliding-DFT path (128 % nfft == 0) streams whole-block
    assert pfb.default_chunk_groups(128, 48) == 1
    assert pfb.default_chunk_groups(32, 48) == 1
    # fft / stacked-matmul paths must group the 48-chunk axis or they
    # OOM a 16 GB chip on full-geometry blocks (regression: bench --pfb 1024)
    assert pfb.default_chunk_groups(1024, 48) > 1
    assert pfb.default_chunk_groups(256, 48) > 1
    # explicit method override is honored
    assert pfb.default_chunk_groups(128, 48, method="fft") > 1
    # non-standard chunk counts still get a divisor
    for nchk in (48, 24, 12, 7, 1):
        g = pfb.default_chunk_groups(1024, nchk)
        assert nchk % g == 0


# --------------------------------------------------------------------------
# nfft = 128 (frame-aligned factored FIR + DFT) and the rows layout entry
# --------------------------------------------------------------------------

@pytest.mark.parametrize("ntap", [3, 4])
def test_pfb_128_golden_parity(ntap):
    block = F.synthetic_block(rng=40, ndf=32, nchk=NCHK)
    got = np.asarray(pfb.pfb_power(jnp.asarray(block), 128, ntap))
    want = pfb.pfb_power_golden(block, 128, ntap)
    np.testing.assert_allclose(got, want, rtol=2e-4)


def test_pfb_128_rows_streaming_carry():
    """Rows streaming over 2 blocks == one double block; the raw int16
    rows carry normalizes to the wire path's edge-frame carry."""
    b1 = F.synthetic_block(rng=41, ndf=32, nchk=NCHK)
    b2 = F.synthetic_block(rng=42, ndf=32, nchk=NCHK)
    both = np.concatenate([b1, b2], axis=0)
    step = pfb.make_streaming_pfb(128, 4, layout="rows")
    p1, h1 = step(jnp.asarray(F.block_to_rows(b1)), None)
    p2, h2 = step(jnp.asarray(F.block_to_rows(b2)), h1)
    total = np.asarray(p1) + np.asarray(p2)
    want = pfb.pfb_power_golden(both, 128, 4)
    np.testing.assert_allclose(total, want, rtol=2e-4)
    ref = pfb.pfb_history(jnp.asarray(b2), 128, 4)
    np.testing.assert_allclose(
        np.asarray(pfb.history_as_complex(h2, 4, 128)), np.asarray(ref))


def test_pfb_128_mean_rows_agrees_with_wire():
    block = F.synthetic_block(rng=43, ndf=32, nchk=NCHK)
    a = np.asarray(pfb.pfb_power(jnp.asarray(block), 128, 4, mean=True))
    b = np.asarray(pfb.pfb_power(jnp.asarray(F.block_to_rows(block)), 128,
                                 4, mean=True, layout="rows"))
    np.testing.assert_allclose(a, b, rtol=1e-6)


def test_pfb_2d_block_and_layout_validation():
    block = F.synthetic_block(rng=44, ndf=32, nchk=NCHK)
    flat = jnp.asarray(block.reshape(32, -1))
    a = np.asarray(pfb.pfb_power(flat, 128))
    b = np.asarray(pfb.pfb_power(jnp.asarray(block), 128))
    np.testing.assert_allclose(a, b)
    with pytest.raises(ValueError):                  # wire block as rows
        pfb.pfb_power(flat, 128, layout="rows")
    with pytest.raises(ValueError):
        pfb.pfb_power(flat, 128, layout="bogus")


@pytest.mark.parametrize("nfft", [128, 1024])
@pytest.mark.parametrize("stokes", [False, True])
def test_pfb_rows_entry_matches_wire(nfft, stokes):
    """Series rows hold the complex series _block_to_series builds: the
    rows entry of pfb_power / pfb_spectra gives the wire layout's output
    and, streamed, its carry."""
    b1 = F.synthetic_block(rng=45, ndf=64, nchk=NCHK)
    b2 = F.synthetic_block(rng=46, ndf=64, nchk=NCHK)
    if stokes:
        steps = {lay: pfb.make_streaming_spectra(nfft, 4, nout=2,
                                                 stokes=True, layout=lay)
                 for lay in ("wire", "rows")}
    else:
        steps = {lay: pfb.make_streaming_pfb(nfft, 4, layout=lay)
                 for lay in ("wire", "rows")}
    outs = {}
    for lay, conv in (("wire", lambda b: b), ("rows", F.block_to_rows)):
        o1, h = steps[lay](jnp.asarray(conv(b1)), None)
        o2, h = steps[lay](jnp.asarray(conv(b2)), h)
        outs[lay] = (np.asarray(o1), np.asarray(o2),
                     np.asarray(pfb.history_as_complex(h, 4, nfft)))
    for w, r in zip(outs["wire"], outs["rows"]):
        np.testing.assert_allclose(r, w, rtol=1e-6,
                                   atol=1e-6 * float(np.abs(w).max()))


def test_xla_paths_accept_rows_i16_carry():
    """Cross-format safety: a rows-layout stream's raw rows-i16 carry
    feeds the wire-layout paths too (a stream may change layout between
    blocks) and matches the canonical complex one exactly
    (history_as_complex)."""
    b1 = F.synthetic_block(rng=61, ndf=NDF, nchk=NCHK)
    b2 = F.synthetic_block(rng=62, ndf=NDF, nchk=NCHK)
    # the raw carry as the rows layout produces it: trailing frame rows
    nfft = 128  # frame-aligned halo needs nfft multiple of NSAMP_DF
    halo_ndf = (NTAP - 1) * nfft // C.NSAMP_DF
    rows_tail = jnp.asarray(np.ascontiguousarray(
        b1[-halo_ndf:].transpose(1, 3, 4, 0, 2, 5)
        .reshape(NCHK * 14, halo_ndf, 256)))
    complex_h = pfb.pfb_history(jnp.asarray(b1), nfft, NTAP)
    np.testing.assert_allclose(
        np.asarray(pfb.history_as_complex(rows_tail, NTAP, nfft)),
        np.asarray(complex_h))
    a = np.asarray(pfb.pfb_power(jnp.asarray(b2), nfft, NTAP,
                                 history=rows_tail))
    b = np.asarray(pfb.pfb_power(jnp.asarray(b2), nfft, NTAP,
                                 history=complex_h))
    np.testing.assert_allclose(a, b, rtol=1e-6)
    sa = np.asarray(pfb.pfb_spectra(jnp.asarray(b2), nfft, NTAP, nout=2,
                                    history=rows_tail))
    sb = np.asarray(pfb.pfb_spectra(jnp.asarray(b2), nfft, NTAP, nout=2,
                                    history=complex_h))
    np.testing.assert_allclose(sa, sb, rtol=1e-6)
