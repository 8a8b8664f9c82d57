"""Runtime checking and profiling hooks.

The reference wraps every CUDA/cuFFT call in safe-call macros that abort on
error (``cudautil.cuh:9-116``), compiles verbose tracing under ``-DDEBUG``
(``makefile:1-6``), and profiles via an nvprof launcher (``run.py:13-16``).
JAX equivalents:

  * JAX/XLA surface device errors as exceptions at dispatch/fetch time, so
    the safe-call layer reduces to *semantic* checks: power spectra must be
    finite and non-negative. :func:`check_power` enforces that per block
    when debug mode is on.
  * Debug mode: env var ``PAFB2P_DEBUG=1`` (or ``set_debug(True)``) turns
    on per-block validation + verbose pipeline logging — the runtime
    analogue of the reference's ``-DDEBUG`` rebuild (``rebuild.py``).
  * Profiling: :func:`profile_trace` wraps a region in a ``jax.profiler``
    trace viewable in TensorBoard/XProf — the nvprof-wrapper analogue.
"""

from __future__ import annotations

import contextlib
import os

import numpy as np


_DEBUG = os.environ.get("PAFB2P_DEBUG", "0") not in ("", "0", "false")


def debug_enabled() -> bool:
    return _DEBUG


def set_debug(on: bool) -> None:
    global _DEBUG
    _DEBUG = bool(on)


class PowerCheckError(RuntimeError):
    pass


def check_power(power: np.ndarray, block_index: int = -1,
                signed: bool = False) -> None:
    """Validate a detected power vector: finite, non-negative.

    int16 |x|^2 sums are mathematically >= 0 and bounded by
    nsamp * npol * ndim * 32768^2 < 2^52, so NaN/inf/negative values can
    only come from corrupted input or a kernel defect — the class of error
    the reference's CudaSafeCall layer existed to surface early.

    ``signed=True`` (Stokes records: Q/U/V are legitimately negative)
    checks finiteness only.
    """
    power = np.asarray(power)
    if not np.isfinite(power).all():
        bad = int(np.count_nonzero(~np.isfinite(power)))
        raise PowerCheckError(
            f"block {block_index}: {bad} non-finite power values")
    if not signed and (power < 0).any():
        bad = int(np.count_nonzero(power < 0))
        raise PowerCheckError(
            f"block {block_index}: {bad} negative power values")


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """jax.profiler trace context (no-op when log_dir is falsy)."""
    if not log_dir:
        yield
        return
    import jax

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()
