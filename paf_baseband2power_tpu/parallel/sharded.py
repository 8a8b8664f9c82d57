"""shard_map pipelines: multi-device baseband->power.

Communication design (contrast with the reference's PSRDADA shm fabric,
SURVEY.md section 2 last row): the only cross-device exchange the direct
power path needs is a ``psum`` of partial integrations over the ``time``
axis — 336 float32 per block. The ``chunk`` (frequency) axis is
embarrassingly parallel, exactly like the reference's per-NIC chunk
partitioning (``capture.c:570-584``), so it needs no collectives.
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from ..ops.power import baseband2power
from .mesh import BEAM_AXIS, CHUNK_AXIS, TIME_AXIS


def block_sharding(mesh) -> NamedSharding:
    """Sharding for a canonical block: frames over ``time``, chunks over
    ``chunk``."""
    return NamedSharding(mesh, P(TIME_AXIS, CHUNK_AXIS))


def power_sharding(mesh) -> NamedSharding:
    """Sharding for the output power vector: channels follow chunks."""
    return NamedSharding(mesh, P(CHUNK_AXIS))


def make_sharded_power_step(mesh, mean: bool = False):
    """Build the jitted multi-device power step.

    Input: canonical int16 block sharded ``P(time, chunk)``. Each device
    integrates its local (ndf_local, nchk_local) sub-block, then partials
    are ``psum``-ed over the time axis. Output: float32 power of shape
    ``(nchk * 7,)`` sharded over ``chunk``.
    """

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=P(TIME_AXIS, CHUNK_AXIS),
        out_specs=P(CHUNK_AXIS),
    )
    def step(block):
        local = baseband2power(block, mean=False)
        total = jax.lax.psum(local, TIME_AXIS)
        if mean:
            ndf = block.shape[0] * jax.lax.psum(1, TIME_AXIS)
            total = total / (ndf * block.shape[2] * block.shape[4])
        return total

    return jax.jit(step)


def shard_block(block, mesh):
    """Place a host block onto the mesh with the canonical sharding."""
    return jax.device_put(block, block_sharding(mesh))


def make_multibeam_power_step(mesh, mean: bool = False):
    """Multi-beam power step on a ``(beam, time, chunk)`` mesh.

    Input: int16 blocks of shape ``(nbeam, ndf, nchk, nsamp, nchan, npol,
    ndim)`` sharded ``P(beam, time, chunk)``. Beams are embarrassingly
    parallel (DP); partial integrations psum over ``time`` only. Output:
    ``(nbeam, nchan)`` float32 sharded ``P(beam, chunk)``.
    """

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=P(BEAM_AXIS, TIME_AXIS, CHUNK_AXIS),
        out_specs=P(BEAM_AXIS, CHUNK_AXIS),
    )
    def step(blocks):
        local = jax.vmap(lambda b: baseband2power(b, mean=False))(blocks)
        total = jax.lax.psum(local, TIME_AXIS)
        if mean:
            ndf = blocks.shape[1] * jax.lax.psum(1, TIME_AXIS)
            total = total / (ndf * blocks.shape[3] * blocks.shape[5])
        return total

    return jax.jit(step)


def make_multibeam_power_step_2d(mesh, mean: bool = False):
    """Multi-beam power step on the production 2-D-per-beam layout.

    Input: int16 blocks of shape ``(nbeam, ndf, nchk * 3584)`` sharded
    ``P(beam, time, chunk)`` — per-beam blocks exactly as ring buffers and
    the capture engine deliver them, stacked. The 6-D unpack happens on the
    reduced partials *inside* the jitted program, so no 6-D copy of the
    block is ever made.
    Output: ``(nbeam, nchk * 7)`` float32 sharded ``P(beam, chunk)``.
    """
    from ..constants import DT_SIZE, NCHAN_CHK, NDIM_POL, NPOL_SAMP, NSAMP_DF

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=P(BEAM_AXIS, TIME_AXIS, CHUNK_AXIS),
        out_specs=P(BEAM_AXIS, CHUNK_AXIS),
    )
    def step(blocks):
        nbeam_l, ndf_l, lanes_l = blocks.shape
        nchk_l = lanes_l // (DT_SIZE // 2)
        x = blocks.astype(jnp.float32)
        partial = jnp.sum(x * x, axis=1)               # (nbeam_l, lanes_l)
        power = (
            partial.reshape(nbeam_l, nchk_l, NSAMP_DF, NCHAN_CHK,
                            NPOL_SAMP * NDIM_POL)
            .sum(axis=(2, 4))
            .reshape(nbeam_l, nchk_l * NCHAN_CHK)
        )
        total = jax.lax.psum(power, TIME_AXIS)
        if mean:
            ndf = ndf_l * jax.lax.psum(1, TIME_AXIS)
            total = total / (ndf * NSAMP_DF * NPOL_SAMP)
        return total

    return jax.jit(step)


def make_sharded_stokes_step(mesh, mean: bool = False):
    """Multi-device full-Stokes step on the 2-D layout.

    Input int16 ``(ndf, nchk*3584)`` sharded ``P(time, chunk)``; per-shard
    partial Stokes psum over time (4 x nchan floats — still tiny). Output
    ``(4, nchan)`` sharded over chunk. Definitions:
    ``ops.golden.baseband2stokes_golden``.
    """
    from ..ops.power import baseband2stokes_2d

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=P(TIME_AXIS, CHUNK_AXIS),
        out_specs=P(None, CHUNK_AXIS),
    )
    def step(block):
        local = baseband2stokes_2d(block, mean=False)
        total = jax.lax.psum(local, TIME_AXIS)
        if mean:
            from ..constants import NSAMP_DF

            ndf = block.shape[0] * jax.lax.psum(1, TIME_AXIS)
            total = total / (ndf * NSAMP_DF)
        return total

    return jax.jit(step)


def make_sharded_scrunch_step(mesh, nout: int, mean: bool = False):
    """Multi-device sub-block integration: ``nout`` spectra per block.

    Requires the time shards to align with integration windows
    (``n_time | nout``): each shard then owns whole windows and the step
    needs NO collectives at all — the output's window axis is simply
    sharded over ``time`` (alongside ``chunk``), the ideal layout for a
    downstream time-frequency consumer. Output ``(nout, nchan)`` sharded
    ``P(time, chunk)``.
    """
    from ..ops.power import baseband2power_scrunch_2d

    n_time = mesh.shape[TIME_AXIS]
    if nout % n_time:
        raise ValueError(
            f"nout={nout} must be a multiple of the time-shard count "
            f"{n_time} (windows may not straddle shards)")

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=P(TIME_AXIS, CHUNK_AXIS),
        out_specs=P(TIME_AXIS, CHUNK_AXIS),
    )
    def step(block):
        return baseband2power_scrunch_2d(block, nout // n_time, mean=mean)

    return jax.jit(step)


def _halo_exchange(v, n_time: int, halo_len: int):
    """Append the next time shard's leading samples (ppermute to the
    previous shard); the last shard receives zeros."""
    if n_time <= 1:
        return v
    halo = v[..., :halo_len]
    halo_prev = jax.lax.ppermute(
        halo, TIME_AXIS, perm=[(i, i - 1) for i in range(1, n_time)])
    return jnp.concatenate([v, halo_prev], axis=-1)


def _mask_tail_windows(p, tid, n_time: int, ntap: int):
    """Zero the last shard's final ntap-1 windows (its halo was zeros),
    matching the golden one-shot window count. ``p``'s second-to-last
    axis is windows."""
    if n_time <= 1:
        return p
    nwin = p.shape[-2]
    win = jax.lax.broadcasted_iota(jnp.int32, (nwin, 1), 0)
    valid = (tid < n_time - 1) | (win < nwin - (ntap - 1))
    return p * valid.astype(p.dtype)


def _tail_carry(v, tid, n_time: int, halo_len: int):
    """Replicated overlap-save carry: the GLOBAL trailing ``halo_len``
    samples of this block (the last time shard's tail), psum-broadcast so
    every shard holds it for the next block's boundary windows."""
    tail = v[..., -halo_len:]
    if n_time > 1:
        tail = jnp.where(tid == n_time - 1, tail, jnp.zeros_like(tail))
    # psum even at n_time == 1: it erases the time-varying annotation so
    # the carry can leave the shard_map with a time-replicated out_spec
    return jax.lax.psum(tail, TIME_AXIS)


def _composed_shard_body(v, npol: int, n_time: int, nfft: int, ntap: int,
                         nout: int, stokes: bool, method: str, ops,
                         mean: bool, shift: bool, history=None,
                         return_history: bool = False,
                         scatter_output: bool = False):
    """Per-shard composed detection on a local complex series: halo
    exchange, per-window detect, end-row window scatter into global
    slots, group fold, psum over time, normalize. The single shared
    implementation behind ``make_sharded_spectra_step`` and
    ``make_multibeam_composed_step_2d``. Returns ``(nout, [4,] flat)``.

    ``history``: previous block's trailing ``(ntap-1)*nfft`` samples
    (complex, replicated over time shards). With it, the ``ntap-1``
    boundary windows straddling the block edge are produced (they end at
    global slots ``0..ntap-2``, so group 0 gets its full window count) —
    cross-block overlap-save continuity at any device count, matching
    the single-chip streaming steps (``ops/pfb.py:456-575``).
    """
    from ..ops.pfb import _spectra_detect

    halo_len = (ntap - 1) * nfft
    nblk_local = v.shape[-1] // nfft
    slots_total = n_time * nblk_local
    if slots_total % nout:
        raise ValueError(f"nout={nout} must divide {slots_total} slots")
    wpg = slots_total // nout
    if wpg < max(ntap - 1, 1):
        raise ValueError(f"windows per spectrum {wpg} < ntap-1")
    if (history is not None or return_history) and v.shape[-1] < halo_len:
        raise ValueError(
            f"streaming needs >= (ntap-1)*nfft={halo_len} samples per "
            f"time shard, got {v.shape[-1]}")
    tid = jax.lax.axis_index(TIME_AXIS)
    v_lead = v[..., :halo_len]
    carry = _tail_carry(v, tid, n_time, halo_len) if return_history else None
    v = _halo_exchange(v, n_time, halo_len)
    s = _spectra_detect(v, nfft, stokes, method, ops)
    s = _mask_tail_windows(s, tid, n_time, ntap)
    # scatter local windows into global end-row slots: window ending at
    # global slot e lands in spectrum e // wpg, so shard boundaries need
    # not align with output spectra
    buf = jnp.zeros(s.shape[:3] + (slots_total + ntap - 1, nfft), s.dtype)
    start = tid * nblk_local + (ntap - 1)
    buf = jax.lax.dynamic_update_slice_in_dim(buf, s, start, axis=-2)
    if history is not None:
        # boundary windows (history ++ the global leading samples) end at
        # slots 0..ntap-2 — below every shard's own placement, so a set
        # is safe; all but shard 0 masked, merged by the psum below
        sb = _spectra_detect(jnp.concatenate([history, v_lead], axis=-1),
                             nfft, stokes, method, ops)
        sb = sb * (tid == 0).astype(sb.dtype)
        buf = buf.at[..., :ntap - 1, :].set(sb)
    g = buf[..., :slots_total, :].reshape(
        s.shape[:3] + (nout, wpg, nfft)).sum(axis=-2)
    nout_l = nout
    if scatter_output and n_time > 1:
        # reduce_scatter instead of allreduce: each time shard keeps only
        # its own nout/n_time output groups — half the fine-channel
        # waterfall's collective bytes (the one large collective payload)
        # and no broadcast back. Requires n_time | nout (validated in the
        # factory).
        g = jax.lax.psum_scatter(g, TIME_AXIS, scatter_dimension=3,
                                 tiled=True)
        nout_l = nout // n_time
    else:
        g = jax.lax.psum(g, TIME_AXIS)
    if mean:
        nwin_g = jnp.full((nout,), float(wpg))
        if history is None:
            nwin_g = nwin_g.at[0].add(-(ntap - 1))    # one-shot group 0
        nwin_g = jnp.maximum(nwin_g, 1.0)     # 0-window group: 0 not NaN
        if nout_l != nout:
            nwin_g = jax.lax.dynamic_slice_in_dim(
                nwin_g, tid * nout_l, nout_l)
        g = g / (nwin_g * (1 if stokes else npol))[:, None]
    if shift:
        g = jnp.fft.fftshift(g, axes=-1)
    ns = g.shape[2]
    out = g.transpose(3, 2, 0, 1, 4).reshape(nout_l, ns, -1)
    out = out if stokes else out[:, 0]
    return (out, carry) if return_history else out


def _oneshot_step(mesh, body, in_spec, out_spec):
    """jit(shard_map) of a ``body(x, history, return_history)`` in its
    one-shot form — shared by every step factory."""
    return jax.jit(functools.partial(
        jax.shard_map, mesh=mesh, in_specs=in_spec,
        out_specs=out_spec)(lambda x: body(x, None, False)))


def _streaming_step(mesh, body, in_spec, out_spec, hspec):
    """The streaming program pair for a ``body(x, history,
    return_history)``: a no-history trace (first block) and a
    with-history trace, behind one ``step(x, history=None) ->
    (out, new_history)`` dispatcher — shared by every step factory."""
    step0 = jax.jit(functools.partial(
        jax.shard_map, mesh=mesh, in_specs=(in_spec,),
        out_specs=(out_spec, hspec))(lambda x: body(x, None, True)))
    step1 = jax.jit(functools.partial(
        jax.shard_map, mesh=mesh, in_specs=(in_spec, hspec),
        out_specs=(out_spec, hspec))(lambda x, h: body(x, h, True)))

    def step(x, history=None):
        return step0(x) if history is None else step1(x, history)

    return step


def _spectra_ops_np(nfft: int, ntap: int, window: str):
    """(method, host operators) for the composed shard bodies."""
    from ..ops.pfb import _MATMUL_NFFT_MAX, pfb_coeffs, pfb_matmul_weights

    method = "matmul" if nfft <= _MATMUL_NFFT_MAX else "fft"
    ops_np = (pfb_matmul_weights(nfft, ntap, window) if method == "matmul"
              else pfb_coeffs(nfft, ntap, window))
    return method, ops_np


def _ops_to_device(method: str, ops_np):
    return (tuple(jnp.asarray(o) for o in ops_np)
            if method == "matmul" else jnp.asarray(ops_np))


def make_sharded_spectra_step(mesh, nfft: int, ntap: int = 4,
                              window: str = "hamming", nout: int = 1,
                              stokes: bool = False, mean: bool = False,
                              shift: bool = True, streaming: bool = False,
                              scatter_output: bool = False):
    """Multi-device composed fine-channel detection: PFB x tscrunch
    waterfall x Stokes under ``shard_map``.

    Communication: the same ppermute overlap-save halo as
    ``make_sharded_pfb_step`` plus one psum of the grouped spectra over
    the time axis (see ``_composed_shard_body``). Output:
    ``(nout, [4,] nchk*7*nfft)`` float32, channels sharded over
    ``chunk``, the spectra/Stokes axes replicated (tiny).

    ``streaming``: ``step(block, history=None) -> (out, new_history)``
    with the complex chunk-sharded carry of ``make_sharded_pfb_step`` —
    group 0 of every non-first block then holds its full window count
    (cross-block overlap-save continuity at any device count).

    ``scatter_output``: reduce_scatter the grouped spectra over the time
    axis instead of allreducing (requires ``n_time | nout``): the output
    spectra axis comes back SHARDED ``P(time, ...)``, each shard owning
    its contiguous nout/n_time groups — half the collective bytes of
    the waterfall psum and the natural layout for a time-frequency
    consumer.
    """
    from ..ops.pfb import _block_to_series

    n_time = mesh.shape[TIME_AXIS]
    if scatter_output and nout % n_time:
        raise ValueError(
            f"scatter_output needs n_time | nout (nout={nout}, "
            f"n_time={n_time})")
    method, ops_np = _spectra_ops_np(nfft, ntap, window)
    scat = scatter_output and n_time > 1
    nout_ax = TIME_AXIS if scat else None
    out_spec = (P(nout_ax, None, CHUNK_AXIS) if stokes
                else P(nout_ax, CHUNK_AXIS))
    in_spec = P(TIME_AXIS, CHUNK_AXIS)
    hspec = P(CHUNK_AXIS)

    def body(block, history, return_history):
        return _composed_shard_body(
            _block_to_series(block), block.shape[4], n_time, nfft, ntap,
            nout, stokes, method, _ops_to_device(method, ops_np), mean,
            shift, history=history, return_history=return_history,
            scatter_output=scatter_output)

    if not streaming:
        return _oneshot_step(mesh, body, in_spec, out_spec)
    return _streaming_step(mesh, body, in_spec, out_spec, hspec)


def make_sharded_pfb_step(mesh, nfft: int, ntap: int = 4,
                          window: str = "hamming", mean: bool = False,
                          shift: bool = True, streaming: bool = False):
    """Build the jitted multi-device PFB spectrometer step.

    Each time shard channelizes its local sub-block. The FIR needs
    ``(ntap-1)*nfft`` samples of look-ahead at the shard boundary, so every
    shard sends its leading halo to the *previous* shard (``ppermute``) —
    the overlap-save boundary state the reference's blocked design avoids
    and a cuFFT channelizer would have forced on it. The last shard has
    no successor: its final ``ntap-1`` windows are masked out, matching the golden model's one-shot window count. Partial
    spectra are then ``psum``-ed over the time axis.

    Output: ``(nchk * 7 * nfft,)`` float32, sharded over ``chunk``.

    ``streaming``: the returned step becomes
    ``step(block, history=None) -> (power, new_history)`` — the carry is
    the block's global trailing ``(ntap-1)*nfft`` samples (complex,
    sharded over ``chunk``, replicated over ``time``), and with history
    the boundary windows straddling the previous block are produced, so
    an N-device stream of K blocks sums to the one-shot golden over the
    concatenated series (cross-block overlap-save continuity at any
    device count — the channelizer contract of ``kernel.cuh:4-7``).
    """
    from ..ops.pfb import _block_to_series, pfb_coeffs

    n_time = mesh.shape[TIME_AXIS]
    coeffs_np = pfb_coeffs(nfft, ntap, window)
    in_spec = P(TIME_AXIS, CHUNK_AXIS)
    hspec = P(CHUNK_AXIS)

    def body(block, history, return_history):
        return _pfb_shard_body(_block_to_series(block), n_time, nfft, ntap,
                               jnp.asarray(coeffs_np), mean, shift,
                               history=history,
                               return_history=return_history)

    if not streaming:
        return _oneshot_step(mesh, body, in_spec, P(CHUNK_AXIS))
    return _streaming_step(mesh, body, in_spec, P(CHUNK_AXIS), hspec)


def _pfb_shard_body(v, n_time: int, nfft: int, ntap: int, coeffs,
                    mean: bool, shift: bool, history=None,
                    return_history: bool = False):
    """Per-shard PFB spectrometer on a local complex series (halo
    exchange, channelize, tail mask, psum) — shared by the flat and
    multibeam step factories. Returns ``(nchk_l*7*nfft,)``.

    ``history``: previous block's trailing ``(ntap-1)*nfft`` samples
    (complex, replicated over time shards) — adds the ``ntap-1`` windows
    straddling the block edge, so a K-block N-device stream sums to the
    one-shot golden over the concatenated series (the single-chip
    streaming property, ``ops/pfb.py:456-575``)."""
    from ..ops.pfb import channelize

    halo_len = (ntap - 1) * nfft
    if (history is not None or return_history) and v.shape[-1] < halo_len:
        raise ValueError(
            f"streaming needs >= (ntap-1)*nfft={halo_len} samples per "
            f"time shard, got {v.shape[-1]}")
    tid = jax.lax.axis_index(TIME_AXIS)
    v_lead = v[..., :halo_len]
    carry = _tail_carry(v, tid, n_time, halo_len) if return_history else None
    v = _halo_exchange(v, n_time, halo_len)
    y = channelize(v, coeffs)                           # (...,nwin,nfft)
    p = y.real * y.real + y.imag * y.imag
    nwin = p.shape[-2]
    p = _mask_tail_windows(p, tid, n_time, ntap)
    power = p.sum(axis=(2, 3))
    nwin_extra = 0
    if history is not None:
        # boundary windows straddling the previous block's end: all
        # shards compute them from the replicated history + the global
        # lead, all but shard 0 masked, merged by the psum
        yb = channelize(jnp.concatenate([history, v_lead], axis=-1), coeffs)
        pb = yb.real * yb.real + yb.imag * yb.imag
        power = power + (pb * (tid == 0).astype(pb.dtype)).sum(axis=(2, 3))
        nwin_extra = ntap - 1
    power = jax.lax.psum(power, TIME_AXIS)
    if mean:
        total_win = jax.lax.psum(nwin, TIME_AXIS) - (
            0 if n_time == 1 else (ntap - 1)) + nwin_extra
        power = power / (p.shape[2] * total_win)
    if shift:
        power = jnp.fft.fftshift(power, axes=-1)
    out = power.reshape(-1)
    return (out, carry) if return_history else out


def make_multibeam_pfb_step_2d(mesh, nfft: int, ntap: int = 4,
                               window: str = "hamming", mean: bool = False,
                               shift: bool = True, streaming: bool = False):
    """PFB spectrometer on the production multi-host mesh: 2-D-per-beam
    blocks sharded ``P(beam, time, chunk)``.

    The per-beam body is the same halo-exchange channelizer as
    ``make_sharded_pfb_step`` (ppermute leading samples to the previous
    time shard, psum partial spectra) vmapped over this shard's beams —
    collectives over the ``time`` mesh axis compose with vmap, so when
    host boundaries land on the time axis the overlap-save halo crosses
    processes over the network.
    Output ``(nbeam, nchk*7*nfft)`` sharded ``P(beam, chunk)``.

    ``streaming``: ``step(blocks, history=None) -> (out, new_history)``
    with a per-beam complex carry ``(nbeam, nchk, 7, npol,
    (ntap-1)*nfft)`` sharded ``P(beam, chunk)`` (replicated over time) —
    cross-block overlap-save continuity across hosts.
    """
    from ..constants import DT_SIZE, NCHAN_CHK, NDIM_POL, NPOL_SAMP, NSAMP_DF
    from ..ops.pfb import _block_to_series, pfb_coeffs

    n_time = mesh.shape[TIME_AXIS]
    coeffs_np = pfb_coeffs(nfft, ntap, window)
    in_spec = P(BEAM_AXIS, TIME_AXIS, CHUNK_AXIS)
    out_spec = P(BEAM_AXIS, CHUNK_AXIS)
    hspec = P(BEAM_AXIS, CHUNK_AXIS)

    def body(blocks, history, return_history):
        nbeam_l, ndf_l, lanes_l = blocks.shape
        nchk_l = lanes_l // (DT_SIZE // 2)

        def one(b2d, h):
            block6 = b2d.reshape(ndf_l, nchk_l, NSAMP_DF, NCHAN_CHK,
                                 NPOL_SAMP, NDIM_POL)
            return _pfb_shard_body(_block_to_series(block6), n_time, nfft,
                                   ntap, jnp.asarray(coeffs_np), mean,
                                   shift, history=h,
                                   return_history=return_history)

        if history is None:
            return jax.vmap(lambda b: one(b, None))(blocks)
        return jax.vmap(one)(blocks, history)

    if not streaming:
        return _oneshot_step(mesh, body, in_spec, out_spec)
    return _streaming_step(mesh, body, in_spec, out_spec, hspec)


def make_sharded_stokes_scrunch_step(mesh, nout: int, mean: bool = False):
    """Multi-device Stokes x sub-block integration (coarse channels).

    Window-aligned like ``make_sharded_scrunch_step`` (``n_time | nout``:
    shards own whole windows, zero collectives); the per-window detect is
    the full-Stokes product set. Output ``(nout, 4, nchan)`` float32
    sharded ``P(time, None, chunk)``.
    """
    from ..ops.power import baseband2stokes_scrunch_2d

    n_time = mesh.shape[TIME_AXIS]
    if nout % n_time:
        raise ValueError(
            f"nout={nout} must be a multiple of the time-shard count "
            f"{n_time} (windows may not straddle shards)")

    @functools.partial(
        jax.shard_map,
        mesh=mesh,
        in_specs=P(TIME_AXIS, CHUNK_AXIS),
        out_specs=P(TIME_AXIS, None, CHUNK_AXIS),
    )
    def step(block):
        return baseband2stokes_scrunch_2d(block, nout // n_time, mean=mean)

    return jax.jit(step)


def make_multibeam_composed_step_2d(mesh, nfft: int = 0, ntap: int = 4,
                                    window: str = "hamming", nout: int = 1,
                                    stokes: bool = False, mean: bool = False,
                                    shift: bool = True,
                                    streaming: bool = False,
                                    scatter_output: bool = False):
    """Composed detection on the multi-host mesh: 2-D-per-beam blocks
    sharded ``P(beam, time, chunk)``, any combination of PFB x Stokes x
    tscrunch.

    With ``nfft``: the ``make_sharded_spectra_step`` body (ppermute halo,
    end-row window scatter, psum) vmapped over this shard's beams — output
    ``(nbeam, nout, [4,] nchan*nfft)`` with the spectra axes replicated.
    Without ``nfft``: window-aligned sub-block detection (``n_time | nout``
    required, zero collectives) — output sharded over ``time`` on the
    spectra axis. Used by ``runtime/multihost.py`` for the composed CLI
    modes.
    """
    from ..constants import DT_SIZE, NCHAN_CHK, NDIM_POL, NPOL_SAMP, NSAMP_DF

    n_time = mesh.shape[TIME_AXIS]
    if streaming and not nfft:
        raise ValueError(
            "streaming carries exist only for fine-channel (nfft > 0) "
            "modes — coarse-channel detection has no cross-block state")
    if scatter_output and not nfft:
        raise ValueError(
            "scatter_output applies to the fine-channel waterfall psum "
            "(nfft > 0); coarse-channel modes have no time-axis "
            "allreduce to scatter")
    if scatter_output and nout % n_time:
        raise ValueError(
            f"scatter_output needs n_time | nout (nout={nout}, "
            f"n_time={n_time})")
    if not nfft and nout == 1:
        if not stokes:
            raise ValueError(
                "nfft=0, nout=1, stokes=False is plain power — use "
                "make_multibeam_power_step_2d (this factory's nfft=0 "
                "branches are the Stokes/scrunch compositions)")
        # plain full-Stokes across hosts: psum of local partials over time
        from ..constants import NSAMP_DF as _NS
        from ..ops.power import baseband2stokes_2d

        @functools.partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=P(BEAM_AXIS, TIME_AXIS, CHUNK_AXIS),
            out_specs=P(BEAM_AXIS, None, CHUNK_AXIS),
        )
        def step(blocks):
            local = jax.vmap(
                lambda b: baseband2stokes_2d(b, mean=False))(blocks)
            total = jax.lax.psum(local, TIME_AXIS)
            if mean:
                ndf = blocks.shape[1] * jax.lax.psum(1, TIME_AXIS)
                total = total / (ndf * _NS)
            return total

        return jax.jit(step)
    if not nfft:
        if nout % n_time:
            raise ValueError(
                f"nout={nout} must be a multiple of the time-shard count "
                f"{n_time} (windows may not straddle shards)")
        from ..ops.power import (
            baseband2power_scrunch_2d,
            baseband2stokes_scrunch_2d,
        )

        @functools.partial(
            jax.shard_map,
            mesh=mesh,
            in_specs=P(BEAM_AXIS, TIME_AXIS, CHUNK_AXIS),
            out_specs=(P(BEAM_AXIS, TIME_AXIS, None, CHUNK_AXIS) if stokes
                       else P(BEAM_AXIS, TIME_AXIS, CHUNK_AXIS)),
        )
        def step(blocks):
            fn = (baseband2stokes_scrunch_2d if stokes
                  else baseband2power_scrunch_2d)
            return jax.vmap(
                lambda b: fn(b, nout // n_time, mean=mean))(blocks)

        return jax.jit(step)

    from ..ops.pfb import _block_to_series

    method, ops_np = _spectra_ops_np(nfft, ntap, window)
    scat = scatter_output and n_time > 1
    nout_ax = TIME_AXIS if scat else None
    out_spec = (P(BEAM_AXIS, nout_ax, None, CHUNK_AXIS) if stokes
                else P(BEAM_AXIS, nout_ax, CHUNK_AXIS))
    in_spec = P(BEAM_AXIS, TIME_AXIS, CHUNK_AXIS)
    hspec = P(BEAM_AXIS, CHUNK_AXIS)

    def body(blocks, history, return_history):
        nbeam_l, ndf_l, lanes_l = blocks.shape
        nchk_l = lanes_l // (DT_SIZE // 2)
        ops = _ops_to_device(method, ops_np)

        def one(b2d, h):
            block6 = b2d.reshape(ndf_l, nchk_l, NSAMP_DF, NCHAN_CHK,
                                 NPOL_SAMP, NDIM_POL)
            return _composed_shard_body(
                _block_to_series(block6), NPOL_SAMP, n_time, nfft, ntap,
                nout, stokes, method, ops, mean, shift, history=h,
                return_history=return_history,
                scatter_output=scatter_output)

        if history is None:
            return jax.vmap(lambda b: one(b, None))(blocks)
        return jax.vmap(one)(blocks, history)

    if not streaming:
        return _oneshot_step(mesh, body, in_spec, out_spec)
    return _streaming_step(mesh, body, in_spec, out_spec, hspec)


def _rows_body(rows, history, return_history, nfft: int, ntap: int,
               window: str, nout: int, stokes: bool, mean: bool,
               shift: bool):
    """Per-shard detection of a series-row block ``(nseries, ndf, 256)``.

    Every rows step is series-independent, so a shard holding whole
    frequency chunks needs no collective. Returns ``(nout, [4,]
    nchan*max(nfft,1))`` (+ the raw int16 rows carry with
    ``return_history``)."""
    from ..constants import NCHAN_CHK, NPOL_SAMP
    from ..ops.pfb import pfb_spectra
    from ..ops.power import (
        baseband2power_scrunch_rows,
        baseband2stokes_scrunch_rows,
    )

    if rows.shape[0] % (NCHAN_CHK * NPOL_SAMP):
        raise ValueError(
            f"series shard {rows.shape[0]} must hold whole frequency "
            f"chunks ({NCHAN_CHK * NPOL_SAMP} series each): use a chunk "
            "mesh extent dividing nchk")
    if nfft:
        return pfb_spectra(
            rows, nfft, ntap, window=window, nout=nout, stokes=stokes,
            mean=mean, shift=shift, layout="rows", history=history,
            return_history=return_history)
    fn = (baseband2stokes_scrunch_rows if stokes
          else baseband2power_scrunch_rows)
    return fn(rows, nout, mean=mean)


def make_multibeam_rows_step(mesh, nfft: int = 0, ntap: int = 4,
                             window: str = "hamming", nout: int = 1,
                             stokes: bool = False, mean: bool = False,
                             shift: bool = True, streaming: bool = False):
    """Beam-parallel detection on device-layout (series-row) blocks.

    The rows layout makes beam data-parallelism trivial: a beam-stacked
    rows block ``(nbeam, nseries, ndf, 256) int16`` is, per beam, exactly
    what a ``capture --device-layout`` ring holds, and every rows step is
    series-major — so each beam shard runs the rows steps locally with
    ZERO collectives (the reference's actual scale-out model: one
    independent pipeline per beam/node, ``paf_capture.c:114-118``). Any
    composition: ``nfft`` > 0 for the fine-channel spectrometer, else the
    rows power / Stokes (x tscrunch) reductions.

    The series axis additionally shards over the ``chunk`` mesh axis
    (``make_sharded_rows_step``'s zero-collective TP form), so meshes
    with more devices than beams still use every device — each shard owns
    (its beams) x (a whole-frequency-chunk series range). Requires
    ``n_chunk | nchk``.

    Output (sharded ``P(beam, ..., chunk-on-channels)``):
    ``(nbeam, nout, [4,] nchan*max(nfft,1))`` float32.

    ``streaming`` (``nfft`` > 0 only): ``step(blocks, history=None) ->
    (out, new_history)`` with the raw int16 rows carry, stacked per beam —
    ``(nbeam, nseries, ceil((ntap-1)*nfft/128), 256)`` sharded
    ``P(beam, chunk)`` exactly like the blocks. The carry is a pure slice
    of each shard's own input, so rows streaming needs ZERO collectives.
    """
    if streaming and not nfft:
        raise ValueError(
            "streaming carries exist only for fine-channel (nfft > 0) "
            "modes — coarse-channel detection has no cross-block state")
    out_spec = (P(BEAM_AXIS, None, None, CHUNK_AXIS) if stokes
                else P(BEAM_AXIS, None, CHUNK_AXIS))
    in_spec = P(BEAM_AXIS, CHUNK_AXIS)
    hspec = P(BEAM_AXIS, CHUNK_AXIS)

    def body(blocks, history, return_history):
        def one(rows, h):
            return _rows_body(rows, h, return_history, nfft, ntap, window,
                              nout, stokes, mean, shift)

        if history is None:
            return jax.vmap(lambda b: one(b, None))(blocks)
        return jax.vmap(one)(blocks, history)

    if not streaming:
        return _oneshot_step(mesh, body, in_spec, out_spec)
    return _streaming_step(mesh, body, in_spec, out_spec, hspec)


def make_sharded_rows_step(mesh, nfft: int = 0, ntap: int = 4,
                           window: str = "hamming", nout: int = 1,
                           stokes: bool = False, mean: bool = False,
                           shift: bool = True, streaming: bool = False):
    """Single-beam multi-device detection on a device-layout block:
    the series axis is the natural tensor-parallel axis of the rows
    form — every step (power, Stokes, the fine-channel spectrometer) is
    series-independent, so sharding ``(nseries, ndf, 256)`` over
    ``chunk`` needs ZERO collectives and the output channels simply
    follow their series shard.

    Requires ``n_chunk | nchk`` (shards own whole frequency chunks, so
    polarization pairs and the channel-grouping epilogue never straddle
    shards). Output sharded ``P([...,] chunk)`` on the channel axis:
    ``(nout, [4,] nchan*max(nfft,1))``.

    ``streaming`` (``nfft`` > 0 only): ``step(rows, history=None) ->
    (out, new_history)`` — the raw int16 rows carry
    ``(nseries, ceil((ntap-1)*nfft/128), 256)`` shards over ``chunk``
    exactly like the input (a pure slice of each shard's own series), so
    streaming on the rows TP axis needs ZERO collectives.
    """
    if streaming and not nfft:
        raise ValueError(
            "streaming carries exist only for fine-channel (nfft > 0) "
            "modes — coarse-channel detection has no cross-block state")
    out_spec = (P(None, None, CHUNK_AXIS) if stokes
                else P(None, CHUNK_AXIS))
    hspec = P(CHUNK_AXIS)

    def body(rows, history, return_history):
        return _rows_body(rows, history, return_history, nfft, ntap, window,
                          nout, stokes, mean, shift)

    if not streaming:
        return _oneshot_step(mesh, body, P(CHUNK_AXIS), out_spec)
    return _streaming_step(mesh, body, P(CHUNK_AXIS), out_spec, hspec)
