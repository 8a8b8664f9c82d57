"""Backend policy: one XLA path per mode, stated matmul precision, and a
compile cache that can be placed from outside."""

import os
import re

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from paf_baseband2power_tpu.ops import frame as F
from paf_baseband2power_tpu.ops import pfb
from paf_baseband2power_tpu import runtime

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _program_files() -> list[str]:
    """The program's Python files: the package, bench.py,
    __graft_entry__.py and chip_smoke.py."""
    pkg = os.path.join(REPO, "paf_baseband2power_tpu")
    files = [os.path.join(d, f) for d, _, fs in os.walk(pkg)
             for f in fs if f.endswith(".py")]
    return files + [os.path.join(REPO, f) for f in
                    ("bench.py", "__graft_entry__.py", "chip_smoke.py")]


@pytest.mark.parametrize("pattern,what", [
    (r"pallas\s*\.\s*tpu|pallas\s+import\s+tpu", "TPU Pallas import"),
    (r"""==\s*["']tpu["']|["']tpu["']\s*==|!=\s*["']tpu["']""",
     "branch on a 'tpu' backend"),
    (r"\binterpret\s*=", "interpret= argument"),
])
def test_program_files_have_no_tpu_paths(pattern, what):
    files = _program_files()
    assert len(files) > 20
    bad = []
    for f in files:
        with open(f) as fh:
            for n, line in enumerate(fh, 1):
                if re.search(pattern, line):
                    bad.append(f"{f}:{n}: {line.strip()}")
    assert not bad, f"{what} found:\n" + "\n".join(bad)


def _dot_precisions(fn, *args) -> list:
    """(primitive, precision) of every dot_general / conv in the traced
    program."""
    found = []

    def walk(jaxpr):
        for eqn in jaxpr.eqns:
            if eqn.primitive.name in ("dot_general",
                                      "conv_general_dilated"):
                found.append((eqn.primitive.name, eqn.params["precision"]))
            for sub in jax.core.jaxprs_in_params(eqn.params):
                walk(sub)

    walk(jax.make_jaxpr(fn)(*args).jaxpr)
    return found


@pytest.mark.parametrize("nfft,stokes", [(32, False), (128, False),
                                         (256, False), (128, True)])
def test_pfb_matmuls_declare_precision(nfft, stokes):
    """Every matmul of the PFB paths states PFB_PRECISION and the sliding
    convolution (nfft 32) PFB_CONV_PRECISION (factored DFT at 128, stacked
    matmul at 256 and in the composed spectra): no float32 product is left
    to the backend's default, which may be TF32 on a GPU."""
    block = jnp.asarray(F.synthetic_block(rng=0, ndf=16, nchk=1))
    hist = pfb.pfb_history(block, nfft, 4)
    if stokes:
        fn = lambda b, h: pfb.pfb_spectra(b, nfft, 4, stokes=True,  # noqa
                                          history=h)
    else:
        fn = lambda b, h: pfb.pfb_power(b, nfft, 4, history=h)  # noqa
    precs = _dot_precisions(fn, block, hist)
    assert precs, "no matmul traced"
    assert any(n == "conv_general_dilated" for n, _ in precs) == (nfft == 32)
    for name, p in precs:
        want = (pfb.PFB_CONV_PRECISION if name == "conv_general_dilated"
                else pfb.PFB_PRECISION)
        assert p is not None
        assert want in (p if isinstance(p, tuple) else (p,)), (name, p)


def test_pfb_precision_is_an_explicit_setting():
    for p in (pfb.PFB_PRECISION, pfb.PFB_CONV_PRECISION):
        assert p not in (None, jax.lax.Precision.DEFAULT)


def test_compile_cache_env_dir_wins(monkeypatch):
    """With JAX_COMPILATION_CACHE_DIR set no path is set in code (JAX reads
    the variable itself)."""
    assert runtime.compile_cache_dir(
        {"JAX_COMPILATION_CACHE_DIR": "/elsewhere"}) is None
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/elsewhere")
    before = jax.config.jax_compilation_cache_dir
    runtime.setup_compile_cache()
    assert jax.config.jax_compilation_cache_dir == before


def test_compile_cache_defaults_to_repo():
    assert runtime.compile_cache_dir({}) == os.path.join(REPO, ".jax_cache")
    assert runtime.compile_cache_dir({"PAFB2P_NO_COMPILE_CACHE": "1"}) is None


@pytest.mark.parametrize("prefix", ["site-packages", "dist-packages"])
def test_compile_cache_not_in_install_prefix(monkeypatch, prefix):
    monkeypatch.setattr(runtime, "_REPO",
                        os.path.join(os.sep, "usr", "lib", "python3",
                                     prefix))
    assert runtime.compile_cache_dir({}) is None


def test_gitignore_lists_compile_cache():
    with open(os.path.join(REPO, ".gitignore")) as f:
        assert ".jax_cache/" in f.read().split()


def test_make_step_one_path_per_mode_and_layout():
    """The pipeline's single mode x layout table hands back distinct,
    working steps; a bad layout is an error."""
    from paf_baseband2power_tpu.runtime.pipeline import MODES, make_step

    for kw in MODES.values():
        for layout in ("wire", "rows"):
            assert callable(make_step(layout=layout, **kw))
    with pytest.raises(ValueError):
        make_step(layout="bogus")
    # the stateless rows step squeezes nout=1 to the plain record
    block = F.synthetic_block(rng=1, ndf=8, nchk=1)
    out = make_step(layout="rows")(jnp.asarray(F.block_to_rows(block)))
    assert np.asarray(out).shape == (7,)
