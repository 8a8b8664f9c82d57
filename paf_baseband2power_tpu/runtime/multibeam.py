"""Multi-beam streaming: several capture streams through one mesh program.

The reference serves multiple beams by running disconnected per-beam
pipelines. Here B beam streams are batched into one SPMD step over a
``(beam, time, chunk)`` mesh: beams shard data-parallel, each block's
partial integrations psum over the time axis, and every beam's spectrum
lands in its own sink. One program, one dispatch per block row — a
batching the process-per-beam design cannot do.

Execution discipline matches :class:`~..runtime.pipeline.PowerPipeline`:
per-beam blocks stay in the 2-D wire layout (the 6-D unpack happens inside
the jitted step), ``depth`` block-rows ride in flight so H2D / compute /
fetch overlap, and tiny per-row spectra are stacked on device and fetched
in batches (``fetch_every``) to amortize the fixed host<->device round trip.
"""

from __future__ import annotations

import collections
import time

import numpy as np

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from .. import constants as C
from ..parallel.mesh import BEAM_AXIS, CHUNK_AXIS, TIME_AXIS
from ..parallel.sharded import make_multibeam_power_step_2d
from .log import open_log
from .pipeline import PipelineStats


def run_multibeam(sources, mesh, sinks, mean: bool = False,
                  log_dir: str | None = None, depth: int = 2,
                  fetch_every: int = 1) -> PipelineStats:
    """Drive B per-beam block sources through one sharded step.

    ``sources``: per-beam iterables of 2-D int16 blocks ``(ndf, lanes)``.
    ``sinks``: per-beam objects with ``write(power)``/``close()``.
    Streams until the shortest source is exhausted. ``depth`` bounds
    block-rows in flight (the ring NBLK analogue); ``fetch_every`` batches
    that many block-rows of spectra per device fetch.
    """
    nbeam = len(sources)
    if nbeam != mesh.shape[BEAM_AXIS]:
        raise ValueError(
            f"{nbeam} sources != mesh beam axis {mesh.shape[BEAM_AXIS]}")
    if len(sinks) != nbeam:
        raise ValueError("one sink per beam required")
    log = open_log("multibeam", log_dir)
    step = make_multibeam_power_step_2d(mesh, mean=mean)
    sharding = NamedSharding(mesh, P(BEAM_AXIS, TIME_AXIS, CHUNK_AXIS))
    fetch_every = max(1, fetch_every)
    depth = max(fetch_every, max(1, depth))

    stats = PipelineStats()
    inflight: collections.deque = collections.deque()  # (array, nrows)
    pending: list = []  # device outs awaiting a stacked fetch
    t0 = time.perf_counter()

    def rows_in_flight() -> int:
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
        arr, n = inflight.popleft()
        host = np.asarray(arr)                  # (nbeam, nchan) or stacked
        batch = host[None] if n == 1 else host  # (n, nbeam, nchan)
        for row in batch:
            for b, sink in enumerate(sinks):
                sink.write(row[b])
            stats.nblocks += 1
            stats.nbytes_out += row.nbytes

    try:
        for rows in zip(*sources):
            if not stats.ndf:
                stats.ndf = rows[0].shape[0]
            stacked = np.stack([np.asarray(r).reshape(stats.ndf, -1)
                                for r in rows])
            x = jax.device_put(stacked, sharding)
            pending.append(step(x))
            if len(pending) >= fetch_every:
                flush_pending()
            stats.nbytes_in += stacked.nbytes
            while rows_in_flight() > depth and inflight:
                drain_one()
        flush_pending()
        while inflight:
            drain_one()
        stats.elapsed = time.perf_counter() - t0
    finally:
        for sink in sinks:
            sink.close()
    log.info("multibeam done: %d beams x %d blocks, %.3f s, %.2fx real time",
             nbeam, stats.nblocks, stats.elapsed, stats.realtime_fraction)
    return stats
