"""Polyphase filterbank channelizer + spectral power.

The reference links cuFFT and includes it from its (empty) kernels module
(``makefile:27``, ``kernel.cuh:7``) — a planned fine channelizer in front of
detection that never shipped. This module provides that capability in
XLA: a critically-sampled polyphase filterbank (windowed-sinc prototype FIR
folded to ``(ntap, nfft)`` + FFT, the standard radio-astronomy F-engine
structure) followed by |x|^2 detection and time integration.

Design notes:
  * The FIR fold is expressed as ``ntap`` shifted views multiplied by the
    per-tap coefficients and summed — XLA fuses this into a single pass; no
    gather is required because windows are critically sampled (stride nfft).
  * Block boundaries: an ``(ntap-1)*nfft``-sample history from the previous
    block is prepended (overlap-save). Streaming callers thread the history
    through; one-shot callers get zero history (identical to the golden
    model). Across time-sharded devices the history is exchanged with
    ``ppermute`` (see parallel/sharded.py).
  * Output ordering: coarse-channel-major, fine channels fft-shifted so
    frequency ascends within each coarse channel -> ``(nchan * nfft,)``.

  * Block layouts: the wire layout (canonical 6-D or the 2-D device form
    ``(ndf, nchk*3584)``) and series rows (``(nseries, ndf, 256)``, from
    ``frame.block_to_rows`` / ``capture --device-layout``). Rows hold the
    per-(chunk, chan, pol) complex series already, so they need no corner
    turn; their overlap-save carry is the raw int16 tail frames.
  * Every matmul states ``PFB_PRECISION`` and the convolution
    ``PFB_CONV_PRECISION``: a float32 product left at the backend default
    may run as TF32 (about 3 decimal digits).

Total output for full geometry: 336 * nfft fine channels per integration.
"""

from __future__ import annotations

import functools

import numpy as np

import jax
import jax.numpy as jnp

from ..constants import NCHAN_CHK, NDIM_POL, NPOL_SAMP, NSAMP_DF

# Precision of every PFB matmul and of its convolution, chosen on the H100
# by the error against the float64 golden at full geometry (PERF.md; the
# spectrometer bound is 2e-4 relative). bf16x3 keeps the matmuls ~100x
# inside the bound and is the fastest explicit choice there. The
# convolution (nfft <= 64) ignores dot-algorithm presets on the GPU — its
# error with any preset equals DEFAULT's, i.e. TF32 — so it states HIGHEST.
PFB_PRECISION = jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3
PFB_CONV_PRECISION = jax.lax.Precision.HIGHEST


def pfb_coeffs(nfft: int, ntap: int = 4, window: str = "hamming",
               dtype=np.float32) -> np.ndarray:
    """Prototype low-pass FIR folded to ``(ntap, nfft)``.

    Windowed sinc with cutoff at the fine-channel width (the conventional
    PFB prototype). Normalized to unit DC gain per phase so a constant
    input maps to the k=0 fine channel with unchanged amplitude scale.
    """
    n = np.arange(ntap * nfft, dtype=np.float64)
    x = n / nfft - ntap / 2.0
    sinc = np.sinc(x)
    if window == "hamming":
        win = np.hamming(ntap * nfft)
    elif window == "hanning":
        win = np.hanning(ntap * nfft)
    elif window == "rect":
        win = np.ones(ntap * nfft)
    else:
        raise ValueError(f"unknown window '{window}'")
    h = (sinc * win).reshape(ntap, nfft)
    h /= h.sum(axis=0).mean()
    return h.astype(dtype)


# --------------------------------------------------------------------------
# Golden (NumPy, float64) reference
# --------------------------------------------------------------------------

def channelize_golden(x: np.ndarray, coeffs: np.ndarray) -> np.ndarray:
    """Brute-force PFB: x (..., nsamp) complex -> (..., nwin, nfft) complex."""
    ntap, nfft = coeffs.shape
    nsamp = x.shape[-1]
    nwin = nsamp // nfft - (ntap - 1)
    out_shape = x.shape[:-1] + (nwin, nfft)
    y = np.zeros(out_shape, dtype=np.complex128)
    xr = x.reshape(x.shape[:-1] + (nsamp // nfft, nfft))
    for m in range(nwin):
        z = np.zeros(x.shape[:-1] + (nfft,), dtype=np.complex128)
        for t in range(ntap):
            z = z + coeffs[t] * xr[..., m + t, :]
        y[..., m, :] = np.fft.fft(z, axis=-1)
    return y


def pfb_power_golden(block: np.ndarray, nfft: int, ntap: int = 4,
                     window: str = "hamming", mean: bool = False,
                     shift: bool = True) -> np.ndarray:
    """Golden PFB spectrometer on a canonical 6-D block.

    Returns float32 power of shape ``(nchk * NCHAN_CHK * nfft,)``.
    """
    ndf, nchk, nsamp_df, nchan_chk, npol, ndim = block.shape
    x = block.astype(np.float64)
    v = x[..., 0] + 1j * x[..., 1]                      # (ndf,nchk,ns,nk,np)
    # time series per (chunk, chan, pol): n = f*nsamp_df + s
    v = v.transpose(1, 3, 4, 0, 2).reshape(nchk, nchan_chk, npol,
                                           ndf * nsamp_df)
    coeffs = pfb_coeffs(nfft, ntap, window, dtype=np.float64)
    y = channelize_golden(v, coeffs)                    # (...,nwin,nfft)
    p = np.abs(y) ** 2
    power = p.sum(axis=(2, 3))                          # sum pol, windows
    if mean:
        power = power / (p.shape[2] * p.shape[3])
    if shift:
        power = np.fft.fftshift(power, axes=-1)
    return power.reshape(nchk * nchan_chk * nfft).astype(np.float32)


def pfb_spectra_golden(block: np.ndarray, nfft: int, ntap: int = 4,
                       window: str = "hamming", nout: int = 1,
                       stokes: bool = False, mean: bool = False,
                       shift: bool = True) -> np.ndarray:
    """Golden composed fine-channel detection: PFB x tscrunch x Stokes.

    The reference's planned channelizer (``/root/reference/kernel.cuh:4-7``,
    ``makefile:27`` cuFFT) composed with its "detect ... and average ... in
    time" contract (``paf_baseband2power.cu:20``) implies what F-engine
    backends actually ship: fine-channel spectra *with time resolution*
    (a waterfall) and fine-channel polarimetry. This is the float64 oracle
    for both, and for their composition.

    Window-group convention (streaming-consistent): window ``w`` ends in
    row-slot ``e = w + ntap - 1`` (rows are ``nfft``-sample blocks); its
    output spectrum is ``e // (nblk / nout)``. Boundary windows carried in
    from the previous block end in rows ``0..ntap-2`` and so land in
    spectrum 0 — a two-block stream with history reproduces the one-shot
    golden over the concatenated series exactly, group by group.

    Returns float32 ``(nout, nchan * nfft)`` or, with ``stokes``,
    ``(nout, 4, nchan * nfft)`` ordered I, Q, U, V.
    """
    ndf, nchk, nsamp_df, nchan_chk, npol, ndim = block.shape
    nsamp = ndf * nsamp_df
    nblk = nsamp // nfft
    if nblk % nout:
        raise ValueError(f"nout={nout} must divide {nblk} window slots")
    wpg = nblk // nout
    if wpg < max(ntap - 1, 1):
        raise ValueError(
            f"windows per spectrum {wpg} must be >= ntap-1={ntap - 1} "
            "(boundary windows may not straddle output spectra)")
    x = block.astype(np.float64)
    v = (x[..., 0] + 1j * x[..., 1]).transpose(1, 3, 4, 0, 2).reshape(
        nchk, nchan_chk, npol, nsamp)
    coeffs = pfb_coeffs(nfft, ntap, window, dtype=np.float64)
    y = channelize_golden(v, coeffs)        # (chk, chan, pol, nwin, nfft)
    nwin = y.shape[-2]
    if stokes:
        if npol != 2:
            raise ValueError("Stokes needs 2 polarizations")
        yx, yy = y[:, :, 0], y[:, :, 1]
        pxx = np.abs(yx) ** 2
        pyy = np.abs(yy) ** 2
        xy = yx * np.conj(yy)
        s = np.stack([pxx + pyy, pxx - pyy, 2 * xy.real, 2 * xy.imag],
                     axis=2)                # (chk, chan, 4, nwin, nfft)
    else:
        s = (np.abs(y) ** 2).sum(axis=2)[:, :, None]   # (.., 1, nwin, nfft)
    slots = np.zeros(s.shape[:3] + (nblk, nfft))
    slots[..., ntap - 1:ntap - 1 + nwin, :] = s
    g = slots.reshape(s.shape[:3] + (nout, wpg, nfft)).sum(axis=-2)
    if mean:
        nwin_g = np.full(nout, float(wpg))
        nwin_g[0] -= ntap - 1               # one-shot: no boundary windows
        # wpg == ntap-1 leaves spectrum 0 with zero windows one-shot (its
        # sum is exactly 0); clamp so mean mode yields 0, not 0/0 = NaN
        nwin_g = np.maximum(nwin_g, 1.0)
        denom = nwin_g * (1 if stokes else npol)
        g = g / denom[:, None]
    if shift:
        g = np.fft.fftshift(g, axes=-1)
    out = g.transpose(3, 2, 0, 1, 4).reshape(nout, s.shape[2],
                                             nchk * nchan_chk * nfft)
    out = out.astype(np.float32)
    return out if stokes else out[:, 0]


# --------------------------------------------------------------------------
# JAX implementation
# --------------------------------------------------------------------------

def pfb_matmul_weights(nfft: int, ntap: int = 4, window: str = "hamming",
                       dtype=np.float32) -> tuple[np.ndarray, np.ndarray]:
    """Combined FIR x DFT operator for the matmul channelizer path.

    ``W[t*nfft + n, k] = coeffs[t, n] * exp(-2j*pi*k*n/nfft)``, so that for a
    stacked window ``z[m, t*nfft+n] = x[(m+t)*nfft + n]`` the channelizer
    output is the single real-pair matmul ``y[m] = z[m] @ W`` — identical to
    FIR-fold + FFT, but expressed as one ``(ntap*nfft)``-deep contraction.
    Returns ``(W_re, W_im)``.
    """
    c = pfb_coeffs(nfft, ntap, window, dtype=np.float64)
    n = np.arange(nfft)
    ph = np.exp(-2j * np.pi * np.outer(n, n) / nfft)        # (n, k)
    w = (c[:, :, None] * ph[None, :, :]).reshape(ntap * nfft, nfft)
    return w.real.astype(dtype), w.imag.astype(dtype)


def _stack_windows(xr: jax.Array, ntap: int) -> jax.Array:
    """(..., nblk, nfft) -> (..., nwin, ntap*nfft) shifted-window stack."""
    nblk, nfft = xr.shape[-2:]
    nwin = nblk - (ntap - 1)
    parts = [jax.lax.slice_in_dim(xr, t, t + nwin, axis=-2)
             for t in range(ntap)]
    z = jnp.stack(parts, axis=-2)                           # (.,nwin,ntap,nfft)
    return z.reshape(z.shape[:-2] + (ntap * nfft,))


def channelize_matmul(x: jax.Array, w_re: jax.Array, w_im: jax.Array,
                      ) -> tuple[jax.Array, jax.Array]:
    """Matmul PFB: x (..., nsamp) complex64 -> (y_re, y_im) (..., nwin, nfft).

    Numerically identical to ``channelize`` (same prototype FIR, same DFT)
    but maps onto four f32 matmuls instead of FFTs.
    """
    ntapnfft, nfft = w_re.shape
    ntap = ntapnfft // nfft
    nblk = x.shape[-1] // nfft
    xr = x.reshape(x.shape[:-1] + (nblk, nfft))
    z = _stack_windows(xr, ntap)
    zr, zi = jnp.real(z), jnp.imag(z)
    mm = functools.partial(jnp.matmul, precision=PFB_PRECISION)
    y_re = mm(zr, w_re) - mm(zi, w_im)
    y_im = mm(zr, w_im) + mm(zi, w_re)
    return y_re, y_im


# the matmul channelizer's per-sample work grows O(ntap*nfft) against the
# FFT's O(log nfft); beyond this size the FFT path takes over.
_MATMUL_NFFT_MAX = 256


def resolve_method(nfft: int, method: str = "auto") -> str:
    """Resolve ``"auto"`` to the concrete channelizer method for ``nfft``."""
    if method == "auto":
        return "matmul" if nfft <= _MATMUL_NFFT_MAX else "fft"
    return method


def default_chunk_groups(nfft: int, nchk: int, method: str = "auto") -> int:
    """Chunk-group count that keeps the channelizer inside device memory.

    The frame-aligned sliding-DFT path (``128 % nfft == 0``) streams rows and
    fits full-geometry blocks whole — grouping would only add slice copies.
    The fft and stacked-matmul paths materialize ~13-22 GB of complex /
    window temporaries on a full block if channelized at once; splitting the
    48-chunk axis into 16 sequential groups bounds that under ~1.5 GB.
    """
    if resolve_method(nfft, method) == "matmul" and _SLIDE_LANES % nfft == 0:
        return 1
    for g in (16, 12, 8, 6, 4, 3, 2):
        if nchk % g == 0:
            return g
    return 1

_SLIDE_LANES = NSAMP_DF  # one frame's 128 samples: rows of 128 complex samples


def pfb_sliding_mats(nfft: int, ntap: int = 4, window: str = "hamming",
                     ) -> np.ndarray:
    """Row-aligned sliding-DFT operator bank: ``(D, 256, 256) float32``.

    The frame-aligned form of the matmul channelizer. The complex series is
    viewed as rows of ``L=128`` samples (one frame each), as ``2L`` f32
    lanes in the ``[re(L) | im(L)]`` block layout of ``_block_to_rows``.
    Window ``m = g*q + r`` (``g = L/nfft`` windows start in each row ``q``)
    spans rows ``q .. q+D-1``, so

        ``y[g*q + r, k] = sum_d (X[q+d] @ M[d])[lane]``,

    with output lanes ``[0,L) = y_re`` at ``r*nfft+k`` and ``[L,2L) = y_im``.
    ``M[d][2j+e, ...]`` carries the DFT phase times the FIR coefficient for
    input sample ``j`` of row ``q+d`` (``e``: re/im), or zero when that
    sample falls outside window ``m``: one ``(nrow,256)@(256,256)`` matmul
    per ``d`` (``D = 1 + ceil((ntap-1)*nfft/L)``) and shifted row adds
    carry the whole FIR+DFT. Requires ``128 % nfft == 0``.
    """
    L = _SLIDE_LANES
    if L % nfft:
        raise ValueError(f"nfft={nfft} must divide {L}")
    w_re, w_im = pfb_matmul_weights(nfft, ntap, window, dtype=np.float64)
    w = w_re + 1j * w_im                                  # (ntap*nfft, nfft)
    g = L // nfft
    d_count = 1 + -(-((ntap - 1) * nfft) // L)
    # input rows are [re lanes | im lanes] blocks
    mats = np.zeros((d_count, 2 * L, 2 * L), np.float64)
    for d in range(d_count):
        for r in range(g):
            col = np.arange(r * nfft, (r + 1) * nfft)
            for j in range(L):
                s = j + d * L - r * nfft                  # sample-in-window
                if 0 <= s < ntap * nfft:
                    mats[d, j, col] = w[s].real
                    mats[d, L + j, col] = -w[s].imag
                    mats[d, j, L + col] = w[s].imag
                    mats[d, L + j, L + col] = w[s].real
    return mats.astype(np.float32)


def pfb_sliding_fir_dft(nfft: int, ntap: int = 4, window: str = "hamming",
                        ) -> tuple[np.ndarray, np.ndarray]:
    """Factored row-aligned PFB operators for ``nfft == 128``: the FIR as
    per-tap lane-coefficient vectors, the DFT as one real-pair matmul.

    ``pfb_sliding_mats`` bakes the FIR into the DFT operator, so the conv
    form spends ``ntap * nfft`` MACs per complex sample in matmuls. When
    windows tile rows exactly (``nfft == L``), the FIR is a plain
    elementwise fold across ``ntap`` shifted rows and only the
    ``nfft``-deep DFT contraction is a matmul: 4x less matmul work at
    ntap=4. Returns ``(cvecs (ntap, 2L), fmat (2L, 2L)) float32`` with
    lanes in the ``[re(L) | im(L)]`` block layout of ``_block_to_rows``.
    """
    L = _SLIDE_LANES
    if nfft != L:
        raise ValueError(f"factored sliding form needs nfft == {L}")
    c = pfb_coeffs(nfft, ntap, window, dtype=np.float64)    # (ntap, nfft)
    cvecs = np.concatenate([c, c], axis=1)                  # re | im lanes
    n = np.arange(nfft)
    ph = np.exp(-2j * np.pi * np.outer(n, n) / nfft)        # (n, k)
    fmat = np.zeros((2 * L, 2 * L), np.float64)
    fmat[:L, :L] = ph.real
    fmat[L:, :L] = -ph.imag
    fmat[:L, L:] = ph.imag
    fmat[L:, L:] = ph.real
    return cvecs.astype(np.float32), fmat.astype(np.float32)


def _as_layout(block: jax.Array, layout: str) -> jax.Array:
    """Normalize a block to its layout's canonical device form: wire
    blocks to 6-D (a 2-D ``(ndf, nchk*3584)`` block reshapes inside the
    jitted program), rows blocks to 3-D ``(nseries, ndf, 256)``."""
    if layout == "wire":
        return _reshape_6d(block)
    if layout != "rows":
        raise ValueError(f"unknown layout '{layout}'")
    lanes = NDIM_POL * NSAMP_DF
    if block.ndim == 2:
        nseries, cols = block.shape
        if cols % lanes:
            raise ValueError(
                f"rows layout needs {lanes}-lane frame segments per series "
                f"row, got {cols} columns — is this a wire-order block "
                "passed as layout='rows'?")
        block = block.reshape(nseries, cols // lanes, lanes)
    if block.ndim != 3 or block.shape[0] % (NCHAN_CHK * NPOL_SAMP):
        raise ValueError(
            f"rows layout needs (nseries, ndf, {lanes}) with nseries "
            f"divisible by {NCHAN_CHK * NPOL_SAMP} (chan*pol per chunk), got "
            f"{block.shape} — is this a wire-order block passed as "
            "layout='rows'?")
    return block


def _geometry(block: jax.Array, layout: str) -> tuple[int, int, int]:
    """``(ndf, nchk, npol)`` of a block in its canonical layout form."""
    if layout == "rows":
        nseries, ndf, _ = block.shape
        return ndf, nseries // (NCHAN_CHK * NPOL_SAMP), NPOL_SAMP
    return block.shape[0], block.shape[1], block.shape[4]


def _frames(block: jax.Array, layout: str, start: int, stop: int | None
            ) -> jax.Array:
    """Frames ``[start, stop)`` of a block in either layout."""
    return block[:, start:stop] if layout == "rows" else block[start:stop]


def _block_to_rows(block: jax.Array, layout: str = "wire") -> jax.Array:
    """int16 block -> f32 sliding rows ``(nchk, 7, npol, ndf, 256)``.

    One BMF frame carries exactly ``L=128`` consecutive time samples per
    (chunk, chan, pol), so the row form of the sliding DFT is one transpose
    of the raw wire block — no complex64 intermediate. Lanes are
    ``[re(128) | im(128)]`` blocks. Series rows already hold each row; only
    their interleaved re/im lanes are split into the two blocks.
    """
    x = block.astype(jnp.float32)
    if layout == "rows":
        ndf = x.shape[1]
        y = x.reshape(-1, NCHAN_CHK, NPOL_SAMP, ndf, _SLIDE_LANES, NDIM_POL)
        y = y.swapaxes(-1, -2)                     # (nchk,7,pol,ndf,dim,128)
    else:
        y = x.transpose(1, 3, 4, 0, 5, 2)          # (nchk,7,pol,ndf,dim,128)
    return y.reshape(y.shape[:-2] + (2 * _SLIDE_LANES,))


def _pfb_detect_sliding(xrows: jax.Array, mats: jax.Array, nfft: int,
                        ntap: int, mean: bool,
                        fir_dft=None) -> jax.Array:
    """Sliding-DFT channelize + detect -> (nchk, nchan_chk, nfft).

    ``xrows``: f32 ``(nchk, nchan_chk, npol, nrow, 2L)`` from
    ``_block_to_rows``. The ``D`` shifted row-matmuls are expressed as one
    causal 1-D convolution (feature dim 2L -> 2L, kernel width D, zero
    future-padding) instead of materializing every shifted product.

    ``fir_dft`` (``nfft == L`` only): factored ``(cvecs, fmat)`` operators
    from ``pfb_sliding_fir_dft`` — the FIR fold runs as an elementwise sum
    of ``ntap`` shifted rows (fused by XLA) and only the nfft-deep DFT is a
    matmul instead of the ntap*nfft-deep conv. This formulation still
    writes its intermediates (rows, z, y) to device memory; a fused
    kernel would keep them on chip.
    """
    L = _SLIDE_LANES
    nchk, nchan, npol, nrow, _ = xrows.shape
    g = L // nfft
    nwin = nrow * g - (ntap - 1)

    lhs = xrows.reshape(nchk * nchan * npol, nrow, 2 * L)
    if fir_dft is not None:
        cvecs, fmat = fir_dft
        # zero-pad the tail rows: the last ntap-1 windows read past the
        # series end, matching the conv path's future-padding + mask
        lhs_p = jnp.pad(lhs, ((0, 0), (0, ntap - 1), (0, 0)))
        z = cvecs[0] * lhs
        for t in range(1, ntap):
            z = z + cvecs[t] * jax.lax.slice_in_dim(
                lhs_p, t, t + nrow, axis=1)
        y = jnp.matmul(z, fmat, precision=PFB_PRECISION)
    else:
        d_count = mats.shape[0]
        y = jax.lax.conv_general_dilated(
            lhs, mats,                                    # (D, 2L, 2L) = WIO
            window_strides=(1,), padding=[(0, d_count - 1)],
            dimension_numbers=("NWC", "WIO", "NWC"),
            precision=PFB_CONV_PRECISION)
    p = y * y
    p = p[..., :L] + p[..., L:]                           # |y|^2, (.,nrow,L)
    # zero-padded tail rows produce the ntap-1 windows past the series end
    win_id = (jax.lax.broadcasted_iota(jnp.int32, (nrow, L), 0) * g
              + jax.lax.broadcasted_iota(jnp.int32, (nrow, L), 1) // nfft)
    p = p * (win_id < nwin).astype(p.dtype)
    power = p.sum(axis=1)                                 # window rows
    power = power.reshape(nchk, nchan, npol, g, nfft).sum(axis=(2, 3))
    if mean:
        power = power / (npol * nwin)
    return power


def _block_to_series(block: jax.Array, layout: str = "wire") -> jax.Array:
    """int16 block -> complex64 (nchk, nchan_chk, npol, nsamp).

    Series rows are that series already (interleaved re/im lanes): a
    reshape, no transpose. Wire blocks need the corner turn.
    """
    x = block.astype(jnp.float32)
    if layout == "rows":
        nseries, ndf, _ = x.shape
        x = x.reshape(nseries // (NCHAN_CHK * NPOL_SAMP), NCHAN_CHK,
                      NPOL_SAMP, ndf * NSAMP_DF, NDIM_POL)
        return jax.lax.complex(x[..., 0], x[..., 1])
    ndf, nchk, nsamp_df, nchan_chk, npol, _ = block.shape
    v = jax.lax.complex(x[..., 0], x[..., 1])
    return v.transpose(1, 3, 4, 0, 2).reshape(nchk, nchan_chk, npol,
                                              ndf * nsamp_df)


def _rows_carry(block: jax.Array, ntap: int, nfft: int) -> jax.Array:
    """Overlap-save carry of a rows block: its raw int16 tail frames
    ``(nseries, ceil((ntap-1)*nfft/128), 256)`` — a pure slice, sharded
    with its series, so rows streaming needs no collective to carry it."""
    halo_ndf = -(-(ntap - 1) * nfft // NSAMP_DF)
    return block[:, block.shape[1] - halo_ndf:]


def channelize(x: jax.Array, coeffs: jax.Array) -> jax.Array:
    """PFB: x (..., nsamp) complex64 -> (..., nwin, nfft) complex64.

    FIR fold as ntap shifted strided views; FFT over the last axis.
    """
    ntap, nfft = coeffs.shape
    nsamp = x.shape[-1]
    nblk = nsamp // nfft
    nwin = nblk - (ntap - 1)
    xr = x.reshape(x.shape[:-1] + (nblk, nfft))
    z = jnp.zeros(x.shape[:-1] + (nwin, nfft), dtype=x.dtype)
    for t in range(ntap):
        z = z + coeffs[t] * jax.lax.slice_in_dim(xr, t, t + nwin, axis=-2)
    return jnp.fft.fft(z, axis=-1)


def _pfb_detect(v: jax.Array, coeffs: jax.Array, mean: bool) -> jax.Array:
    """Channelize + detect a complex series -> (nchk, nchan_chk, nfft)."""
    y = channelize(v, coeffs)
    p = y.real * y.real + y.imag * y.imag
    power = p.sum(axis=(2, 3))
    if mean:
        power = power / (p.shape[2] * p.shape[3])
    return power


def _pfb_detect_matmul(v: jax.Array, w_re: jax.Array, w_im: jax.Array,
                       mean: bool) -> jax.Array:
    """Matmul channelize + detect -> (nchk, nchan_chk, nfft)."""
    y_re, y_im = channelize_matmul(v, w_re, w_im)
    p = y_re * y_re + y_im * y_im
    power = p.sum(axis=(2, 3))
    if mean:
        power = power / (p.shape[2] * p.shape[3])
    return power


@functools.partial(jax.jit,
                   static_argnames=("nfft", "ntap", "window", "mean", "shift",
                                    "chunk_groups", "return_history",
                                    "method", "layout"))
def pfb_power(block: jax.Array, nfft: int, ntap: int = 4,
              window: str = "hamming", mean: bool = False,
              shift: bool = True,
              history: jax.Array | None = None,
              chunk_groups: int | None = None,
              return_history: bool = False,
              method: str = "auto", layout: str = "wire"):
    """PFB spectrometer: int16 block -> (nchan * nfft,) float32 power.

    ``block``: a wire block (canonical 6-D or the 2-D device layout) with
    ``layout="wire"``, or series rows ``(nseries, ndf, 256)`` (or their 2-D
    flattening) with ``layout="rows"``.

    ``history``: optional overlap-save carry from the previous block: the
    complex ``(nchk, nchan_chk, npol, (ntap-1)*nfft)`` series tail
    (``pfb_history``, what the wire layout returns) or the raw int16 rows
    tail (what the rows layout returns); ``history_as_complex`` accepts
    both. With history, all ``nsamp/nfft`` windows of this block are
    produced; without it the first ``ntap-1`` windows are simply absent
    (matching the golden model's one-shot behavior).

    ``chunk_groups``: channelize the chunk axis in this many sequential
    groups (``lax.map`` over contiguous slices). The FFT path needs ~13 GB
    of complex temporaries if channelized at once — 8-16 groups keeps it
    inside device memory. The sliding-matmul path fits whole-block; leave
    groups at 1 there (each group costs a slice copy). ``None`` (default)
    picks per method via ``default_chunk_groups``.

    ``method``: ``"matmul"`` (FIR+DFT as matmuls — the frame-aligned
    sliding form of ``pfb_sliding_mats`` when ``128 % nfft == 0``, else the
    stacked form of ``pfb_matmul_weights``), ``"fft"`` (``jnp.fft``), or
    ``"auto"`` — matmul while ``nfft <= 256``, fft beyond. Identical PFB
    either way.
    """
    block = _as_layout(block, layout)
    ndf, nchk, npol = _geometry(block, layout)
    halo = (ntap - 1) * nfft
    if history is not None:
        history = history_as_complex(history, ntap, nfft, npol)
    if chunk_groups is None:
        chunk_groups = default_chunk_groups(nfft, nchk, method)
    method = resolve_method(nfft, method)
    boundary_detect = None
    if method == "matmul":
        w_re, w_im = (jnp.asarray(w)
                      for w in pfb_matmul_weights(nfft, ntap, window))
        stacked = functools.partial(_pfb_detect_matmul, w_re=w_re, w_im=w_im)
        if _SLIDE_LANES % nfft == 0:
            # frame-aligned main pass; the (tiny, unaligned) boundary
            # windows go through the generic stacked form
            fir_dft = None
            if nfft == _SLIDE_LANES:
                cvecs, fmat = pfb_sliding_fir_dft(nfft, ntap, window)
                fir_dft = (jnp.asarray(cvecs), jnp.asarray(fmat))
                mats = jnp.zeros((0, 0, 0), jnp.float32)  # unused
            else:
                mats = jnp.asarray(pfb_sliding_mats(nfft, ntap, window))
            detect = functools.partial(_pfb_detect_sliding, mats=mats,
                                       nfft=nfft, ntap=ntap,
                                       fir_dft=fir_dft)
            boundary_detect = stacked
        else:
            detect = stacked
    elif method == "fft":
        coeffs = jnp.asarray(pfb_coeffs(nfft, ntap, window))
        detect = functools.partial(_pfb_detect, coeffs=coeffs)
    else:
        raise ValueError(f"unknown method '{method}'")
    sliding = boundary_detect is not None
    if sliding:
        # main pass on the row form (no complex64); the tiny boundary /
        # history series are built from a few edge frames only
        data = _block_to_rows(block, layout)
        halo_ndf = -(-halo // NSAMP_DF)
        v_lead = _block_to_series(_frames(block, layout, 0, halo_ndf),
                                  layout)[..., :halo]
        v_tail = _block_to_series(_frames(block, layout, ndf - halo_ndf,
                                          None), layout)[..., -halo:]
        nsamp = ndf * NSAMP_DF
    else:
        boundary_detect = detect
        data = v = _block_to_series(block, layout)
        v_lead, v_tail = v[..., :halo], v[..., -halo:]
        nsamp = v.shape[-1]
    nwin_main = nsamp // nfft - (ntap - 1)

    if chunk_groups <= 1 or nchk % chunk_groups:
        power = detect(data, mean=False)
    else:
        g = nchk // chunk_groups

        def one(i):
            sub = jax.lax.dynamic_slice_in_dim(data, i * g, g, axis=0)
            return detect(sub, mean=False)

        power = jax.lax.map(one, jnp.arange(chunk_groups))
        power = power.reshape(nchk, NCHAN_CHK, nfft)

    nwin_total = nwin_main
    if history is not None:
        # Boundary windows: the ntap-1 windows straddling the block edge use
        # history + the block's leading samples. Computing them separately
        # (tiny) keeps the main pass on nfft-aligned windows and avoids a
        # full-series concat.
        boundary = jnp.concatenate([history, v_lead], axis=-1)
        power = power + boundary_detect(boundary, mean=False)
        nwin_total += ntap - 1

    if mean:
        power = power / (npol * nwin_total)
    if shift:
        power = jnp.fft.fftshift(power, axes=-1)
    power = power.reshape(-1)
    if return_history:
        return power, (_rows_carry(block, ntap, nfft) if layout == "rows"
                       else v_tail)
    return power


def pfb_history(block: jax.Array, nfft: int, ntap: int = 4) -> jax.Array:
    """Trailing ``(ntap-1)*nfft`` samples of a wire block, as the next
    block's complex overlap-save carry."""
    v = _block_to_series(block)
    return v[..., -(ntap - 1) * nfft:]


def history_as_complex(history: jax.Array, ntap: int, nfft: int,
                       npol: int = 2) -> jax.Array:
    """Normalize an overlap-save carry to the canonical complex format
    ``(nchk, nchan_chk, npol, (ntap-1)*nfft)`` (what ``pfb_history``
    returns).

    The rows layout returns its carry as raw int16 tail frames
    ``(nseries, halo_ndf, 256)`` — a pure slice of its input; the
    trailing ``(ntap-1)*nfft`` samples of those frames are the carry.
    Complex input passes through unchanged.
    """
    if jnp.iscomplexobj(history):
        return history
    nseries, halo_ndf, _ = history.shape
    nchk = nseries // (NCHAN_CHK * npol)
    halo = (ntap - 1) * nfft
    t = history.astype(jnp.float32).reshape(nchk, NCHAN_CHK, npol,
                                            halo_ndf * NSAMP_DF, NDIM_POL)
    t = t[..., t.shape[3] - halo:, :]
    return jax.lax.complex(t[..., 0], t[..., 1])


def _spectra_detect(v: jax.Array, nfft: int, stokes: bool, method: str,
                    ops) -> jax.Array:
    """Channelize + per-window detect: complex series ``(gchk, nchan, npol,
    nsamp)`` -> ``(gchk, nchan, ns, nwin, nfft)`` (ns = 4 Stokes or 1)."""
    if method == "matmul":
        w_re, w_im = ops
        y_re, y_im = channelize_matmul(v, w_re, w_im)
    else:
        y = channelize(v, ops)
        y_re, y_im = jnp.real(y), jnp.imag(y)
    if stokes:
        xr, xi = y_re[:, :, 0], y_im[:, :, 0]
        yr, yi = y_re[:, :, 1], y_im[:, :, 1]
        pxx = xr * xr + xi * xi
        pyy = yr * yr + yi * yi
        re = xr * yr + xi * yi                       # Re(x y*)
        im = xi * yr - xr * yi                       # Im(x y*)
        return jnp.stack([pxx + pyy, pxx - pyy, 2 * re, 2 * im], axis=2)
    p = y_re * y_re + y_im * y_im
    return p.sum(axis=2)[:, :, None]


def _group_windows(s: jax.Array, nout: int, wpg: int, ntap: int,
                   nblk: int) -> jax.Array:
    """Window-group fold: ``(..., nwin, nfft) -> (..., nout, nfft)``.

    Window ``w`` lands in slot ``e = w + ntap - 1`` (its end row); slots
    fold into ``nout`` contiguous groups of ``wpg`` — a front zero-pad plus
    reshape-sum, no gathers (groups are contiguous in end-row order).
    """
    nwin = s.shape[-2]
    pad = [(0, 0)] * (s.ndim - 2) + [(ntap - 1, nblk - (ntap - 1) - nwin),
                                     (0, 0)]
    s = jnp.pad(s, pad)
    return s.reshape(s.shape[:-2] + (nout, wpg, s.shape[-1])).sum(axis=-2)


def spectra_chunk_groups(nchk: int) -> int:
    """Chunk-group count for the composed-spectra path (fft / stacked
    matmul channelizers both materialize per-window temporaries)."""
    for g in (16, 12, 8, 6, 4, 3, 2):
        if nchk % g == 0:
            return g
    return 1


@functools.partial(jax.jit,
                   static_argnames=("nfft", "ntap", "window", "nout",
                                    "stokes", "mean", "shift",
                                    "chunk_groups", "return_history",
                                    "method", "layout"))
def pfb_spectra(block: jax.Array, nfft: int, ntap: int = 4,
                window: str = "hamming", nout: int = 1,
                stokes: bool = False, mean: bool = False, shift: bool = True,
                history: jax.Array | None = None,
                chunk_groups: int | None = None,
                return_history: bool = False,
                method: str = "auto", layout: str = "wire"):
    """Composed fine-channel detection (XLA): PFB x tscrunch x Stokes.

    The general-``nfft`` realization of ``pfb_spectra_golden``'s contract:
    ``(nout, nchan*nfft)`` waterfall spectra, or ``(nout, 4, nchan*nfft)``
    fine-channel Stokes. ``nout=1, stokes=False`` reduces to ``pfb_power``
    semantics (kept separate: that path has the tuned whole-block sliding
    formulation; this one needs per-window products before the time fold,
    so it channelizes via the stacked-matmul (nfft <= 256) or fft method
    with the chunk axis processed in sequential groups).

    ``block`` and ``layout`` as in ``pfb_power``. ``history``: either carry
    format of ``pfb_power``; the ``ntap-1`` boundary windows it enables
    land in output spectrum 0 (end-row convention — see the golden
    docstring). The returned carry is the complex series tail for wire
    blocks and the raw int16 tail frames for rows blocks.
    """
    block = _as_layout(block, layout)
    ndf, nchk, npol = _geometry(block, layout)
    nsamp = ndf * NSAMP_DF
    nblk = nsamp // nfft
    if nblk % nout:
        raise ValueError(f"nout={nout} must divide {nblk} window slots")
    wpg = nblk // nout
    if wpg < max(ntap - 1, 1):
        raise ValueError(
            f"windows per spectrum {wpg} must be >= ntap-1={ntap - 1}")
    if method == "auto":
        method = "matmul" if nfft <= _MATMUL_NFFT_MAX else "fft"
    if method == "matmul":
        ops = tuple(jnp.asarray(w)
                    for w in pfb_matmul_weights(nfft, ntap, window))
    elif method == "fft":
        ops = jnp.asarray(pfb_coeffs(nfft, ntap, window))
    else:
        raise ValueError(f"unknown method '{method}'")
    if chunk_groups is None:
        chunk_groups = spectra_chunk_groups(nchk)

    v = _block_to_series(block, layout)
    halo = (ntap - 1) * nfft

    def detect_group(sub):
        s = _spectra_detect(sub, nfft, stokes, method, ops)
        return _group_windows(s, nout, wpg, ntap, nblk)

    if chunk_groups <= 1 or nchk % chunk_groups:
        g = detect_group(v)
    else:
        gsz = nchk // chunk_groups

        def one(i):
            sub = jax.lax.dynamic_slice_in_dim(v, i * gsz, gsz, axis=0)
            return detect_group(sub)

        g = jax.lax.map(one, jnp.arange(chunk_groups))
        g = g.reshape((nchk,) + g.shape[2:])

    if history is not None:
        history = history_as_complex(history, ntap, nfft, npol)
        boundary = jnp.concatenate([history, v[..., :halo]], axis=-1)
        s_b = _spectra_detect(boundary, nfft, stokes, method, ops)
        g = g.at[..., 0, :].add(s_b.sum(axis=-2))

    ns = g.shape[2]
    if mean:
        nwin_g = jnp.full((nout,), float(wpg))
        if history is None:
            nwin_g = nwin_g.at[0].add(-(ntap - 1))
        nwin_g = jnp.maximum(nwin_g, 1.0)   # 0-window group 0: 0, not NaN
        denom = nwin_g * (1 if stokes else npol)
        g = g / denom[:, None]
    if shift:
        g = jnp.fft.fftshift(g, axes=-1)
    out = g.transpose(3, 2, 0, 1, 4).reshape(nout, ns,
                                             nchk * NCHAN_CHK * nfft)
    if not stokes:
        out = out[:, 0]
    if return_history:
        return out, (_rows_carry(block, ntap, nfft) if layout == "rows"
                     else v[..., -halo:])
    return out


def _reshape_6d(block):
    if block.ndim == 2:
        ndf, lanes = block.shape
        block = block.reshape(ndf, lanes // (NSAMP_DF * NCHAN_CHK *
                                             NPOL_SAMP * 2),
                              NSAMP_DF, NCHAN_CHK, NPOL_SAMP, 2)
    return block


def make_streaming_spectra(nfft: int, ntap: int = 4, nout: int = 1,
                           stokes: bool = False, **kw):
    """Return ``step(block, history) -> (spectra, new_history)`` for the
    composed fine-channel modes; ``kw`` goes to ``pfb_spectra`` (``layout``
    among it), so the step takes wire blocks (6-D or 2-D) or rows blocks.
    """

    @jax.jit
    def step(block, history):
        return pfb_spectra(block, nfft, ntap, nout=nout, stokes=stokes,
                           history=history, return_history=True, **kw)

    return step


def make_streaming_pfb(nfft: int, ntap: int = 4,
                       chunk_groups: int | None = None, **kw):
    """Return ``step(block, history) -> (power, new_history)`` for
    stateful streaming across blocks; ``kw`` goes to ``pfb_power``.

    ``block`` may be the canonical 6-D array, the production 2-D device
    layout ``(ndf, nchk*3584) int16``, or (``layout="rows"``) series rows —
    the reshape happens inside the one jitted program.
    """

    @jax.jit
    def step(block, history):
        return pfb_power(block, nfft, ntap, history=history,
                         chunk_groups=chunk_groups, return_history=True,
                         **kw)

    return step
