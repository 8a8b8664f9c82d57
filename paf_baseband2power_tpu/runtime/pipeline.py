"""Streaming executor: the single-process replacement for the reference's
3-process ring-buffer pipeline.

Where the reference overlaps stages with OS processes + PSRDADA block queues
(``paf-baseband2power.py:117-127``; NBLK 8/4 deep ring buffers), this
executor overlaps them inside one process with JAX's async dispatch:

    host source  ->  device_put (H2D, async)  ->  jitted power step
                 ->  bounded in-flight queue  ->  fetch -> sink

``depth`` bounds the number of blocks in flight, playing the role of the
ring's NBLK: the host thread only blocks when the device is ``depth`` blocks
behind, giving the same producer/consumer pacing as ring-buffer
open/close-block without any IPC.

Failure policy mirrors the reference (SURVEY.md section 5): a source that
stops yields EOD and the pipeline drains and closes cleanly; per-block
timing is recorded for the statistics report (``capture.c:700-725``
analogue).
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Callable, Iterable, Iterator

import numpy as np

import jax

from .. import constants as C
from ..io.dada import DadaFileReader, DadaFileWriter, DadaHeader, output_header

from . import debug
from .log import open_log


@dataclasses.dataclass
class PipelineStats:
    nblocks: int = 0
    nbytes_in: int = 0
    nbytes_out: int = 0
    ndf: int = 0                     # frames per block (from the stream)
    elapsed: float = 0.0
    block_seconds: list = dataclasses.field(default_factory=list)

    @property
    def samples_per_sec(self) -> float:
        if not self.elapsed:
            return 0.0
        nsamp = self.nbytes_in // (C.NPOL_SAMP * C.NDIM_POL * C.NBYTE_IN)
        return nsamp * C.NPOL_SAMP / self.elapsed  # complex samples (both pols)

    @property
    def realtime_fraction(self) -> float:
        """How many real-time streams this run sustained (>=1 is real
        time). Uses the actual frames-per-block of the stream, so reduced
        test geometries report honestly."""
        if not self.elapsed or not self.ndf:
            return 0.0
        stream_sec = self.nblocks * self.ndf * C.TDF_SEC
        return stream_sec / self.elapsed


class SyntheticSource:
    """In-memory block generator (the software BMF, for tests/benchmarks)."""

    def __init__(self, nblocks: int, ndf: int = C.NDF_BLK,
                 nchk: int = C.NCHK_NIC, seed: int = 0, scale: float = 64.0):
        from ..ops.frame import synthetic_block

        self.header = None
        self._blocks = nblocks
        self._ndf, self._nchk = ndf, nchk
        self._seed, self._scale = seed, scale
        self._gen = synthetic_block

    def __iter__(self) -> Iterator[np.ndarray]:
        for i in range(self._blocks):
            b = self._gen(rng=self._seed + i, ndf=self._ndf, nchk=self._nchk,
                          scale=self._scale)
            yield b.reshape(self._ndf, -1)


class FileSource:
    """Replay a recorded DADA baseband file (the ``paf_diskdb`` analogue,
    ``diskdb.cu:74-124``: skip file header, stream whole blocks).

    Recordings made from a device-layout ring (header ``ORDER SERIES``)
    are auto-detected and viewed as series-row blocks; ``layout``
    overrides.
    """

    def __init__(self, path: str, ndf: int = C.NDF_BLK,
                 nchk: int = C.NCHK_NIC, layout: str | None = None):
        self._reader = DadaFileReader(path)
        self.header = self._reader.header
        self._ndf, self._nchk = ndf, nchk
        if layout is None:
            layout = ("rows" if (self.header or {}).get("ORDER") == "SERIES"
                      else "wire")
        if layout not in ("wire", "rows"):
            raise ValueError(f"unknown layout '{layout}'")
        self.layout = layout
        self.block_nbytes = ndf * nchk * C.DT_SIZE

    def __iter__(self) -> Iterator[np.ndarray]:
        for raw in self._reader.blocks(self.block_nbytes):
            x = np.frombuffer(raw, dtype="<i2")
            if self.layout == "rows":
                yield x.reshape(self._nchk * C.NCHAN_CHK * C.NPOL_SAMP, -1)
            else:
                yield x.reshape(self._ndf, -1)
        self._reader.close()


class FileSink:
    """Spill power records to a .dada file (the ``dada_dbdisk`` analogue)."""

    def __init__(self, path: str, header: DadaHeader | None = None):
        self._writer = DadaFileWriter(path, header or output_header())

    def write(self, power: np.ndarray) -> None:
        self._writer.write(np.ascontiguousarray(power, dtype="<f4"))

    def close(self) -> None:
        self._writer.close()


class MemorySink:
    """Collect power vectors in memory (tests)."""

    def __init__(self):
        self.records: list[np.ndarray] = []

    def write(self, power: np.ndarray) -> None:
        self.records.append(np.asarray(power).copy())

    def close(self) -> None:
        pass


class PowerPipeline:
    """Run source -> device power step -> sink with bounded overlap.

    With ``pfb_nfft`` set, the compute step is the streaming PFB
    spectrometer: the overlap-save history rides along as a device-resident
    carry between blocks (the boundary state a cuFFT channelizer would have
    forced on the reference's blocked design).
    """

    def __init__(self, power_fn: Callable | None = None, mean: bool = False,
                 depth: int = 2, name: str = "baseband2power",
                 log_dir: str | None = None, pfb_nfft: int = 0,
                 pfb_ntap: int = 4, pfb_window: str = "hamming",
                 fetch_every: int = 1, stokes: bool = False, nout: int = 1,
                 device_layout: bool = False):
        self._stateful = bool(pfb_nfft)
        self._signed = stokes  # Q/U/V records are legitimately negative
        self._device_layout = device_layout
        if power_fn is None:
            power_fn = make_step(
                mean=mean, nfft=pfb_nfft, ntap=pfb_ntap, window=pfb_window,
                stokes=stokes, nout=nout,
                layout="rows" if device_layout else "wire")
        self._power_fn = power_fn
        # fetch_every > 1: stack that many (tiny) power outputs on device
        # and fetch them as one transfer, amortizing the fixed per-fetch
        # host<->device round trip at high block cadences. The sink sees
        # the same per-block records, fetch_every-1 blocks later.
        self._fetch_every = max(1, fetch_every)
        self._depth = max(self._fetch_every, max(1, depth))
        self.log = open_log(name, log_dir)

    def warmup(self, ndf: int, nchk: int = C.NCHK_NIC) -> float:
        """Compile the power step for the stream geometry; returns seconds.

        Real-time callers must warm up before data starts flowing: the
        first-block JIT compile (seconds to tens of seconds) otherwise
        stalls the consumer, fills the ring, and trips the
        capture fall-behind policy. Runs on zeros of the production 2-D
        layout; the stateful PFB step is run twice to compile both the
        no-history and with-history programs.
        """
        import jax.numpy as jnp

        t0 = time.perf_counter()
        # zeros created on device: a host block would be 2.8 GB at full
        # geometry and ship it through the (slow) H2D path for nothing
        if self._device_layout:
            x = jnp.zeros((nchk * C.NCHAN_CHK * C.NPOL_SAMP, ndf, 256),
                          dtype=jnp.int16)
        else:
            x = jnp.zeros((ndf, nchk * C.DT_SIZE // 2), dtype=jnp.int16)
        if self._stateful:
            out, carry = self._power_fn(x, None)
            np.asarray(out)
            out, _ = self._power_fn(x, carry)
        else:
            out = self._power_fn(x)
        np.asarray(out)
        if self._fetch_every > 1:
            # the stacked-fetch program is distinct — compiling it on the
            # first mid-stream flush would stall the ring reader
            np.asarray(jnp.stack([out] * self._fetch_every))
        dt = time.perf_counter() - t0
        self.log.info("warmup: compiled power step for (%d, %d) in %.2f s",
                      ndf, nchk, dt)
        return dt

    def run(self, source: Iterable[np.ndarray], sink) -> PipelineStats:
        import jax.numpy as jnp

        stats = PipelineStats()
        inflight: collections.deque = collections.deque()  # (array, nblocks)
        pending: list = []           # device outs awaiting a stacked fetch
        t_start = time.perf_counter()
        t_block = t_start
        carry = None
        self.log.info("pipeline start: depth=%d fetch_every=%d stateful=%s",
                      self._depth, self._fetch_every, self._stateful)

        def blocks_in_flight() -> int:
            return sum(n for _, n in inflight) + len(pending)

        def flush_pending():
            if not pending:
                return
            if len(pending) == 1:
                inflight.append((pending[0], 1))
            else:
                inflight.append((jnp.stack(pending), len(pending)))
            pending.clear()

        def drain_one():
            nonlocal t_block
            arr, n = inflight.popleft()
            host = np.asarray(arr)
            rows = host[None] if n == 1 else host
            now = time.perf_counter()
            per_block = (now - t_block) / n
            for row in rows:
                if debug.debug_enabled():
                    debug.check_power(row, stats.nblocks,
                                      signed=self._signed)
                    self.log.info("block %d ok: sum=%.6g max=%.6g",
                                  stats.nblocks, row.sum(), row.max())
                sink.write(row)
                stats.block_seconds.append(per_block)
                stats.nbytes_out += row.size * 4
                stats.nblocks += 1
            t_block = now

        try:
            for block in source:
                if self._device_layout and block.ndim == 2:
                    # rows blocks go H2D 3-D (nseries, ndf, 256), the form
                    # the rows steps take (the host reshape is free)
                    block = block.reshape(block.shape[0], -1, 256)
                if not stats.ndf:
                    # frames per block: rows-layout blocks are
                    # (nseries, ndf, 256), wire blocks (ndf, lanes)
                    stats.ndf = (block.shape[1]
                                 if self._device_layout else block.shape[0])
                x = jax.device_put(block)
                if self._stateful:
                    out, carry = self._power_fn(x, carry)
                else:
                    out = self._power_fn(x)
                pending.append(out)
                if len(pending) >= self._fetch_every:
                    flush_pending()
                stats.nbytes_in += block.nbytes
                while blocks_in_flight() > self._depth and inflight:
                    drain_one()
            flush_pending()
            while inflight:
                drain_one()
            stats.elapsed = time.perf_counter() - t_start
        finally:
            sink.close()
        self.log.info(
            "pipeline done: %d blocks, %.3f s, %.3g samp/s, %.2fx real time",
            stats.nblocks, stats.elapsed, stats.samples_per_sec,
            stats.realtime_fraction,
        )
        return stats


# Every detection mode PowerPipeline dispatches, as ``make_step`` keyword
# arguments, at the sizes the benchmark and the on-card smoke run cover.
MODES = {
    "power": {},
    "tscrunch64": {"nout": 64},
    "stokes": {"stokes": True},
    "stokes_tscrunch64": {"stokes": True, "nout": 64},
    "pfb128": {"nfft": 128},
    "pfb1024": {"nfft": 1024},
    "pfb128_stokes": {"nfft": 128, "stokes": True},
    "pfb128_waterfall64": {"nfft": 128, "nout": 64},
    "pfb1024_waterfall64_stokes": {"nfft": 1024, "nout": 64, "stokes": True},
}


def make_step(mean: bool = False, nfft: int = 0, ntap: int = 4,
              window: str = "hamming", stokes: bool = False, nout: int = 1,
              layout: str = "wire") -> Callable:
    """The device step for one detection mode on one block layout.

    The single place that maps mode x layout to a step: ``step(block)``
    for the stateless coarse-channel modes, ``step(block, history) ->
    (out, new_history)`` for the fine-channel (``nfft`` > 0) modes, whose
    overlap-save carry rides between blocks. Outputs keep the record
    shapes the sink writes: ``(nchan,)`` for plain power (``nout=1``, no
    Stokes), else ``([nout,] [4,] nchan*max(nfft,1))``.
    """
    import functools

    from ..ops import pfb, power

    if layout not in ("wire", "rows"):
        raise ValueError(f"unknown layout '{layout}'")
    if nfft:
        if stokes or nout > 1:
            return pfb.make_streaming_spectra(
                nfft, ntap, nout=nout, stokes=stokes, window=window,
                mean=mean, layout=layout)
        return pfb.make_streaming_pfb(nfft, ntap, window=window, mean=mean,
                                      layout=layout)
    if layout == "rows":
        fn = (power.baseband2stokes_scrunch_rows if stokes
              else power.baseband2power_scrunch_rows)
        if nout > 1:
            return functools.partial(fn, nout=nout, mean=mean)

        @jax.jit
        def rows_step(block):
            return fn(block, 1, mean=mean)[0]

        return rows_step
    if stokes and nout > 1:
        return functools.partial(power.baseband2stokes_scrunch_2d,
                                 nout=nout, mean=mean)
    if nout > 1:
        return functools.partial(power.baseband2power_scrunch_2d, nout=nout,
                                 mean=mean)
    if stokes:
        return functools.partial(power.baseband2stokes_2d, mean=mean)
    return functools.partial(power.baseband2power_2d, mean=mean)
