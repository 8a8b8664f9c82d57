"""Device-mesh construction for the baseband->power pipeline.

The reference scales by share-nothing deployment: one capture+GPU pipeline
per NIC/beam/node, partitioned by the UDP addressing scheme
(``capture.c:570-584``). This design replaces that with a single SPMD
program over a named mesh. The mesh follows the algorithm only: the cards
of one host reach each other all to all (NVLink), so no axis order is
cheaper than another there.

  * ``time``  — the 8192-frame block axis is split into sub-blocks; each
    device integrates its partial window and the partials are ``psum``-ed
    (cheap: the reduced payload is 336 floats).
  * ``chunk`` — the 48 frequency chunks (336 channels) are sharded; no
    communication is needed on this axis at all, mirroring the reference's
    frequency partitioning.

Beams (multiple streams) map onto either axis as a leading batch dimension.
"""

from __future__ import annotations

import jax
import numpy as np
from jax.sharding import Mesh

TIME_AXIS = "time"
CHUNK_AXIS = "chunk"
BEAM_AXIS = "beam"


def make_mesh(n_time: int | None = None, n_chunk: int | None = None,
              devices=None) -> Mesh:
    """Build a ``(time, chunk)`` mesh over ``devices``.

    With no sizes given, all devices go on the time axis (always valid:
    chunk counts are 48-divisible only for 1/2/4/8/16-way sharding, while
    the 8192-frame axis divides by any power of two).
    """
    devices = np.asarray(devices if devices is not None else jax.devices())
    n = devices.size
    if n_time is None and n_chunk is None:
        n_time, n_chunk = n, 1
    elif n_time is None:
        n_time = n // n_chunk
    elif n_chunk is None:
        n_chunk = n // n_time
    if n_time * n_chunk != n:
        raise ValueError(f"mesh {n_time}x{n_chunk} != {n} devices")
    return Mesh(devices.reshape(n_time, n_chunk), (TIME_AXIS, CHUNK_AXIS))


def make_beam_mesh(n_beam: int, n_time: int = 1, n_chunk: int = 1,
                   devices=None) -> Mesh:
    """Build a ``(beam, time, chunk)`` mesh.

    Beams are the pure data-parallel axis — the SPMD analogue of the
    reference's one-pipeline-per-beam deployment (beam id in the frame
    header, ``hdr.c:25``; share-nothing across nodes). No collectives ever
    cross the beam axis.
    """
    devices = np.asarray(devices if devices is not None else jax.devices())
    if n_beam * n_time * n_chunk != devices.size:
        raise ValueError(
            f"mesh {n_beam}x{n_time}x{n_chunk} != {devices.size} devices")
    return Mesh(devices.reshape(n_beam, n_time, n_chunk),
                (BEAM_AXIS, TIME_AXIS, CHUNK_AXIS))
