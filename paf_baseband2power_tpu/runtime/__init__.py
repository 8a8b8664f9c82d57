"""Runtime package: streaming executors, logging, debug/validation.

Also hosts :func:`setup_compile_cache`, the persistent-compile-cache setup
every entry point calls before its first compile.
"""

import os

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def compile_cache_dir(environ=os.environ) -> str | None:
    """The directory this program sets as JAX's persistent compile cache.

    ``None`` when ``JAX_COMPILATION_CACHE_DIR`` is set (JAX reads that
    variable itself, and no other path is set in code), when
    ``PAFB2P_NO_COMPILE_CACHE`` opts out, or for an installed package
    (whose install prefix is no place to write). Otherwise the fixed
    ``<repo>/.jax_cache`` of the checkout (gitignored): the path is part of
    the cache key, so it must not move between runs.
    """
    if (environ.get("JAX_COMPILATION_CACHE_DIR")
            or environ.get("PAFB2P_NO_COMPILE_CACHE")):
        return None
    parts = _REPO.split(os.sep)
    if "site-packages" in parts or "dist-packages" in parts:
        return None
    return os.path.join(_REPO, ".jax_cache")


def setup_compile_cache() -> None:
    """Point JAX's persistent compile cache at :func:`compile_cache_dir`.

    Repeat runs of unchanged program shapes then skip compilation, which
    matters for real-time starts: a cold warmup stalls the ring reader.
    """
    cache = compile_cache_dir()
    if cache is None:
        return
    import jax

    jax.config.update("jax_compilation_cache_dir", cache)
