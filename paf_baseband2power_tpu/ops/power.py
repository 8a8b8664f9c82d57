"""JAX/XLA compute path: unpack int16 baseband -> detect |x|^2 -> integrate.

This is the re-design of the reference's (unshipped) GPU stage (contract:
``paf_baseband2power.cu:20-27`` usage, ``header_baseband2power.txt:39-42``
output spec, ``README.md:2`` integration math). Instead of discrete
H2D-copy / unpack-kernel / detect-kernel / reduce-kernel launches, the whole
conversion is a single jitted expression: XLA fuses the int16->f32 convert,
square, and the first reduction stage into one pass over device memory,
which is the speed-of-light formulation for this bandwidth-bound op.

Numerical contract: accumulation is hierarchical in float32 — samples within
a frame first (<= 2^9 terms), then across frames (<= 2^13 terms) — keeping
round-off well inside the float32 parity bound vs the float64 golden model.

Input layouts accepted:
  * canonical block array  (ndf, nchk, NSAMP_DF, NCHAN_CHK, NPOL, NDIM) int16
  * 2-D wire device layout (ndf, nchk * LANES_PER_CHUNK) int16
  * series rows            (nseries, ndf, 256) int16 (``frame.block_to_rows``)
  * raw ring-block bytes   (nbytes,) uint8  (zero-copy reinterpret on device)
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp

from ..constants import (
    DT_SIZE,
    NCHAN_CHK,
    NCHK_NIC,
    NDF_BLK,
    NDIM_POL,
    NPOL_SAMP,
    NSAMP_DF,
)


def unpack_voltage(block: jax.Array) -> jax.Array:
    """int16 I/Q block -> complex64 voltages of shape (ndf, nchk, nsamp,
    nchan_chk, npol).

    The complex view is only needed by the channelizer path; the direct
    power path never materializes it (|x|^2 needs no complex arithmetic).
    """
    x = block.astype(jnp.float32)
    return jax.lax.complex(x[..., 0], x[..., 1])


def bytes_to_block_device(raw: jax.Array, ndf: int = NDF_BLK,
                          nchk: int = NCHK_NIC) -> jax.Array:
    """Reinterpret raw ring-buffer bytes as the canonical int16 block.

    Little-endian byte pairing matches the wire format; pure bitcast, no
    data movement beyond the load itself.
    """
    pairs = raw.reshape(ndf, nchk, NSAMP_DF, NCHAN_CHK, NPOL_SAMP, NDIM_POL, 2)
    return jax.lax.bitcast_convert_type(pairs, jnp.int16)


def baseband2power(block: jax.Array, mean: bool = False) -> jax.Array:
    """Detect + integrate one block: -> float32 power per channel.

    Output shape ``(nchk * NCHAN_CHK,)`` (336 for full geometry), channel
    index = chunk * 7 + chan, matching the golden model and the reference's
    output header (NCHAN 336, NPOL 1, NDIM 1).

    Deliberately NOT jitted: this is a composable building block (used
    inside shard_map bodies and fused pipelines). A nested-jit call
    boundary forces the 6-D operand into its canonical tiled layout — a
    full-block relayout copy that triples wall clock. Callers jit the
    outermost composition.
    """
    ndf, nchk, nsamp, nchan_chk, npol, ndim = block.shape
    x = block.astype(jnp.float32)
    # Stage 1: everything inside a frame (nsamp*npol*ndim <= 512 terms).
    # XLA fuses convert+mul+reduce; layout keeps nchan_chk*... in lanes.
    partial = jnp.sum(x * x, axis=(2, 4, 5))          # (ndf, nchk, nchan_chk)
    # Stage 2: across frames (<= 8192 terms).
    power = jnp.sum(partial, axis=0)                   # (nchk, nchan_chk)
    if mean:
        power = power / (ndf * nsamp * npol)
    return power.reshape(nchk * nchan_chk)


@functools.partial(jax.jit, static_argnames=("ndf", "nchk", "mean"))
def baseband2power_bytes(raw: jax.Array, ndf: int = NDF_BLK,
                         nchk: int = NCHK_NIC, mean: bool = False) -> jax.Array:
    """Power integration straight from raw ring-block bytes (uint8)."""
    if raw.size != ndf * nchk * DT_SIZE:
        raise ValueError(
            f"raw block must be {ndf * nchk * DT_SIZE} bytes, got {raw.size}"
        )
    return baseband2power(bytes_to_block_device(raw, ndf, nchk), mean=mean)


@functools.partial(jax.jit, static_argnames=("mean",))
def baseband2power_2d(block2d: jax.Array, mean: bool = False) -> jax.Array:
    """XLA power path on the 2-D device layout ``(ndf, nchk*3584) int16``.

    The 2-D layout is the production on-device form: ring blocks go to the
    device as ``(ndf, nchk*3584)``, a free host reshape. The big reduce
    runs over the frame axis with 3584-wide lanes; the tiny lane fold
    (samples x pol x dim -> channel) happens on the reduced (lanes,)
    partial only.
    """
    ndf, lanes = block2d.shape
    if lanes % (DT_SIZE // 2):
        raise ValueError(f"lane dim {lanes} not a multiple of {DT_SIZE // 2}")
    nchk = lanes // (DT_SIZE // 2)
    x = block2d.astype(jnp.float32)
    partial = jnp.sum(x * x, axis=0)                  # (lanes,)
    power = (
        partial.reshape(nchk, NSAMP_DF, NCHAN_CHK, NPOL_SAMP * NDIM_POL)
        .sum(axis=(1, 3))
        .reshape(nchk * NCHAN_CHK)
    )
    if mean:
        power = power / (ndf * NSAMP_DF * NPOL_SAMP)
    return power


@functools.partial(jax.jit, static_argnames=("nout", "mean"))
def baseband2power_scrunch_2d(block2d: jax.Array, nout: int,
                              mean: bool = False) -> jax.Array:
    """Sub-block integration on the 2-D layout: ``(nout, nchan)`` float32.

    The frame axis splits into ``nout`` windows integrated independently
    (oracle: ``ops.golden.baseband2power_scrunch_golden``); still one fused
    pass over HBM — the reduce just keeps a window axis.
    """
    ndf, lanes = block2d.shape
    if ndf % nout:
        raise ValueError(f"nout={nout} must divide ndf={ndf}")
    if lanes % (DT_SIZE // 2):
        raise ValueError(f"lane dim {lanes} not a multiple of {DT_SIZE // 2}")
    nchk = lanes // (DT_SIZE // 2)
    ndf_w = ndf // nout
    x = block2d.reshape(nout, ndf_w, lanes).astype(jnp.float32)
    partial = jnp.sum(x * x, axis=1)                 # (nout, lanes)
    power = (
        partial.reshape(nout, nchk, NSAMP_DF, NCHAN_CHK,
                        NPOL_SAMP * NDIM_POL)
        .sum(axis=(2, 4))
        .reshape(nout, nchk * NCHAN_CHK)
    )
    if mean:
        power = power / (ndf_w * NSAMP_DF * NPOL_SAMP)
    return power


@functools.partial(jax.jit, static_argnames=("mean",))
def baseband2stokes_2d(block2d: jax.Array, mean: bool = False) -> jax.Array:
    """Full-Stokes detection on the 2-D device layout (capability
    extension; definitions in ``ops.golden.baseband2stokes_golden``).

    Same single pass over HBM as the power path — the extra Stokes
    parameters are elementwise products XLA fuses into the load. The big
    reduce runs over the frame axis on (lanes/4)-wide complex groups; the
    sample fold happens on the reduced partials only. Output ``(4, nchan)``
    float32, ordered I, Q, U, V; row 0 equals ``baseband2power_2d`` (sum
    mode).
    """
    ndf, lanes = block2d.shape
    if lanes % (DT_SIZE // 2):
        raise ValueError(f"lane dim {lanes} not a multiple of {DT_SIZE // 2}")
    nchk = lanes // (DT_SIZE // 2)
    # lanes order within a chunk: [nsamp, nchan, pol, dim]
    v = block2d.reshape(ndf, lanes // 4, 2, 2).astype(jnp.float32)
    xr, xi = v[..., 0, 0], v[..., 0, 1]
    yr, yi = v[..., 1, 0], v[..., 1, 1]
    xx, yy = xr * xr + xi * xi, yr * yr + yi * yi
    i_ = jnp.sum(xx + yy, axis=0)                    # (groups,)
    q = jnp.sum(xx - yy, axis=0)
    re = jnp.sum(xr * yr + xi * yi, axis=0)          # Re(x y*)
    im = jnp.sum(xi * yr - xr * yi, axis=0)          # Im(x y*)
    partial = jnp.stack([i_, q, 2 * re, 2 * im])
    stokes = (
        partial.reshape(4, nchk, NSAMP_DF, NCHAN_CHK)
        .sum(axis=2)
        .reshape(4, nchk * NCHAN_CHK)
    )
    if mean:
        stokes = stokes / (ndf * NSAMP_DF)
    return stokes


@functools.partial(jax.jit, static_argnames=("nout", "mean"))
def baseband2stokes_scrunch_2d(block2d: jax.Array, nout: int,
                               mean: bool = False) -> jax.Array:
    """Composed Stokes x sub-block integration on the 2-D device layout:
    ``(nout, 4, nchan)`` float32 (oracle:
    ``ops.golden.baseband2stokes_scrunch_golden``).

    Same single fused HBM pass as ``baseband2stokes_2d`` — the reduce just
    keeps a window axis (the scrunch composition the reference's
    one-integration-per-block design precludes, README.md:2).
    """
    ndf, lanes = block2d.shape
    if ndf % nout:
        raise ValueError(f"nout={nout} must divide ndf={ndf}")
    if lanes % (DT_SIZE // 2):
        raise ValueError(f"lane dim {lanes} not a multiple of {DT_SIZE // 2}")
    nchk = lanes // (DT_SIZE // 2)
    ndf_w = ndf // nout
    v = block2d.reshape(nout, ndf_w, lanes // 4, 2, 2).astype(jnp.float32)
    xr, xi = v[..., 0, 0], v[..., 0, 1]
    yr, yi = v[..., 1, 0], v[..., 1, 1]
    xx, yy = xr * xr + xi * xi, yr * yr + yi * yi
    i_ = jnp.sum(xx + yy, axis=1)                    # (nout, groups)
    q = jnp.sum(xx - yy, axis=1)
    re = jnp.sum(xr * yr + xi * yi, axis=1)
    im = jnp.sum(xi * yr - xr * yi, axis=1)
    partial = jnp.stack([i_, q, 2 * re, 2 * im], axis=1)
    stokes = (
        partial.reshape(nout, 4, nchk, NSAMP_DF, NCHAN_CHK)
        .sum(axis=3)
        .reshape(nout, 4, nchk * NCHAN_CHK)
    )
    if mean:
        stokes = stokes / (ndf_w * NSAMP_DF)
    return stokes


def _rows_3d(rows: jax.Array, nout: int) -> jax.Array:
    """A series-row block as ``(nseries, ndf, 256)``: a 3-D block passes
    through, a 2-D ``(nseries, ndf*256)`` flattening is split per frame.
    Windows align to whole frames, so ``nout`` must divide ``ndf``."""
    if rows.ndim == 2:
        nseries, cols = rows.shape
        if cols % (2 * NSAMP_DF):
            raise ValueError(
                f"rows layout needs {2 * NSAMP_DF}-lane frame segments per "
                f"series row, got {cols} columns")
        rows = rows.reshape(nseries, cols // (2 * NSAMP_DF), 2 * NSAMP_DF)
    if rows.shape[0] % NPOL_SAMP or rows.shape[1] % nout:
        raise ValueError(
            f"nout={nout} must divide the {rows.shape[1]} frames per block "
            f"and the series count {rows.shape[0]} must pair x/y pols "
            "(windows align to whole frames, matching the wire path)")
    return rows


@functools.partial(jax.jit, static_argnames=("nout", "mean"))
def baseband2power_scrunch_rows(rows: jax.Array, nout: int = 1,
                                mean: bool = False) -> jax.Array:
    """Power integration of a host-corner-turned series-row block
    (the capture engine's ``device_layout`` mode): int16
    ``(nseries, ndf, 256)`` with ``nseries = nchk*7*2`` (or its 2-D
    ``(nseries, ndf*256)`` flattening) -> ``(nout, nchan)`` float32
    (squeeze ``nout=1`` for the plain-power record).

    |x|^2 is layout-independent, so this is the same single fused pass
    as the wire-layout path — only the tiny per-series fold differs.
    """
    rows = _rows_3d(rows, nout)
    nseries, ndf, lanes = rows.shape
    x = rows.reshape(nseries, nout, ndf // nout, lanes).astype(jnp.float32)
    partial = jnp.sum(x * x, axis=(2, 3))             # (nseries, nout)
    power = partial.reshape(nseries // NPOL_SAMP, NPOL_SAMP, nout).sum(axis=1)
    power = power.T                                   # (nout, nchan)
    if mean:
        power = power / (ndf // nout * NSAMP_DF * NPOL_SAMP)
    return power


@functools.partial(jax.jit, static_argnames=("nout", "mean"))
def baseband2stokes_scrunch_rows(rows: jax.Array, nout: int = 1,
                                 mean: bool = False) -> jax.Array:
    """Full-Stokes x sub-block integration of a series-row block:
    ``(nout, 4, nchan)`` float32, ordered I, Q, U, V (oracle:
    ``ops.golden.baseband2stokes_scrunch_golden`` of the wire block).

    Series rows come in x/y pairs per channel and lanes interleave re/im
    of 128 samples, so the view ``(npair, pol, nout, ndf_w, 128, re/im)``
    puts both polarizations of a sample side by side: one pass, four
    sums (I, Q, Re(x y*), Im(x y*)). Q sums the per-sample differences
    |x|^2 - |y|^2: forming it as the difference of two window-long sums
    would cancel two large float32 totals.
    """
    rows = _rows_3d(rows, nout)
    nseries, ndf, _ = rows.shape
    v = rows.reshape(nseries // NPOL_SAMP, NPOL_SAMP, nout, ndf // nout,
                     NSAMP_DF, NDIM_POL).astype(jnp.float32)
    xr, xi = v[:, 0, ..., 0], v[:, 0, ..., 1]        # (npair, nout, ndf_w, 128)
    yr, yi = v[:, 1, ..., 0], v[:, 1, ..., 1]
    axes = (2, 3)
    xx, yy = xr * xr + xi * xi, yr * yr + yi * yi
    i_ = jnp.sum(xx + yy, axis=axes)                  # (npair, nout)
    q = jnp.sum(xx - yy, axis=axes)
    re = jnp.sum(xr * yr + xi * yi, axis=axes)        # Re(x y*)
    im = jnp.sum(xi * yr - xr * yi, axis=axes)        # Im(x y*)
    stokes = jnp.stack([i_, q, 2 * re, 2 * im], axis=1)
    stokes = stokes.transpose(2, 1, 0)                # (nout, 4, nchan)
    if mean:
        stokes = stokes / (ndf // nout * NSAMP_DF)
    return stokes


def power_step(block: jax.Array) -> jax.Array:
    """The flagship single-chip forward step (jittable, donate-friendly)."""
    if block.ndim == 2:
        return baseband2power_2d(block)
    return baseband2power(block)
