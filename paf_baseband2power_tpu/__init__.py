"""paf_baseband2power_tpu — JAX PAF baseband->power framework.

A ground-up re-design of the capabilities of xinpingdeng/paf-baseband2power
in JAX, run on an NVIDIA GPU: XLA device steps for unpack -> |x|^2 ->
integrate (plus an optional polyphase-filterbank channelizer), a C++ host
runtime
(shared-memory ring buffers, UDP capture, disk replay/spill) in place of
PSRDADA, and `jax.sharding` mesh scaling in place of per-node share-nothing
deployment.

Layers (mirroring SURVEY.md section 1):
    ops/       frame codec, golden model, jnp device steps, PFB, timing
    parallel/  mesh construction and shard_map pipelines
    io/        DADA header/file codec, ring-buffer bindings
    runtime/   streaming executor, logging, statistics
    cli/       entry points with reference CLI parity
    native/    C++ ring buffer / capture / disk IO (built via make)
"""

from . import constants

__version__ = "0.1.0"
__all__ = ["constants", "__version__"]
