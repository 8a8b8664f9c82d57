"""Multi-host (multi-process) mesh construction.

The reference scales across hosts by running disconnected per-node
pipelines, partitioned by the UDP addressing scheme — there is no cross-
node backend at all (SURVEY.md section 5, "Distributed communication
backend"). This design instead forms one SPMD program over all hosts:
``jax.distributed`` bootstraps the process group (one process per host,
driving all of that host's cards), every host feeds its locally-captured
blocks into the global array, and XLA routes collectives over the cards'
interconnect within a host (NVLink) and the network between hosts.

Axis placement policy: the ``chunk`` axis — whose psum payload is tiny
(336 floats) but whose input bandwidth is huge — stays *within* a host;
``beam`` and ``time`` parallelism, which need no or tiny communication,
span hosts.

Bootstrap is env-driven for cluster launchers, and all three must be set
for a multi-process job (nothing detects a cluster on its own):
  PAFB2P_COORDINATOR  host:port of process 0
  PAFB2P_NUM_PROCS    total processes
  PAFB2P_PROC_ID      this process's rank
"""

from __future__ import annotations

import os

import jax
import numpy as np

from .mesh import BEAM_AXIS, CHUNK_AXIS, TIME_AXIS


def init_distributed(coordinator: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None) -> None:
    """Initialize the jax process group (no-op single-process).

    A multi-process job needs the coordinator address, the process count
    and this process's rank, from the arguments or the environment.
    """
    coordinator = coordinator or os.environ.get("PAFB2P_COORDINATOR")
    if num_processes is None:
        num_processes = int(os.environ.get("PAFB2P_NUM_PROCS", "0")) or None
    if process_id is None:
        pid = os.environ.get("PAFB2P_PROC_ID")
        process_id = int(pid) if pid is not None else None
    if num_processes in (None, 1) and coordinator is None:
        return  # single process
    if coordinator is None or num_processes is None or process_id is None:
        raise ValueError(
            "multi-process jobs need PAFB2P_COORDINATOR, PAFB2P_NUM_PROCS "
            "and PAFB2P_PROC_ID (or the matching arguments) all set")
    jax.distributed.initialize(
        coordinator_address=coordinator,
        num_processes=num_processes,
        process_id=process_id,
    )


def global_mesh(n_beam: int = 1, n_chunk: int | None = None):
    """Build the production global mesh over every device in the job.

    Host boundaries land on the (beam, time) axes; ``n_chunk`` defaults to
    the local device count so the chunk axis never crosses hosts (keeping
    its collectives on the host's own interconnect).
    """
    from .mesh import make_beam_mesh

    devices = np.asarray(jax.devices())
    n = devices.size
    if n_chunk is None:
        n_chunk = min(jax.local_device_count(), n // n_beam)
    while (n // n_beam) % n_chunk:
        n_chunk //= 2
    n_time = n // (n_beam * n_chunk)
    return make_beam_mesh(n_beam, n_time, n_chunk, devices=devices)


def process_block_slice(mesh, nbeam_total: int, ndf_total: int):
    """Which (beam, frame) range this host's feeder should capture.

    With host boundaries on the beam/time axes, each host produces the
    sub-block its devices own; ``jax.make_array_from_process_local_data``
    assembles the global array without cross-host data movement.
    """
    n_beam = mesh.shape[BEAM_AXIS]
    n_time = mesh.shape[TIME_AXIS]
    # device -> (beam, time) coordinates of this process's devices
    local = [d for d in mesh.devices.flat
             if d.process_index == jax.process_index()]
    coords = [np.argwhere(mesh.devices == d)[0] for d in local]
    beams = sorted({int(c[0]) for c in coords})
    times = sorted({int(c[1]) for c in coords})
    # the min..max range below silently computes a WRONG slice unless this
    # process's devices tile a dense (beam x time) rectangle — reject any
    # scattered device-to-process assignment outright
    if beams != list(range(beams[0], beams[-1] + 1)):
        raise ValueError(
            f"process {jax.process_index()} owns non-contiguous beam "
            f"coordinates {beams}; reorder the mesh so each process's "
            "devices form a dense beam range")
    if times != list(range(times[0], times[-1] + 1)):
        raise ValueError(
            f"process {jax.process_index()} owns non-contiguous time "
            f"coordinates {times}; reorder the mesh so each process's "
            "devices form a dense time range")
    cells = {(int(c[0]), int(c[1])) for c in coords}
    if len(cells) != len(beams) * len(times):
        raise ValueError(
            f"process {jax.process_index()} devices do not tile the "
            f"{len(beams)}x{len(times)} (beam x time) rectangle "
            f"({len(cells)} cells); the feeder slice would be wrong")
    beam_per = nbeam_total // n_beam
    ndf_per = ndf_total // n_time
    return (
        (beams[0] * beam_per, (beams[-1] + 1) * beam_per),
        (times[0] * ndf_per, (times[-1] + 1) * ndf_per),
    )
