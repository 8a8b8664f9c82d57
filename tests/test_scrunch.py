"""Sub-block integration (tscrunch): N spectra per block.

Capability extension over the reference's hard-coded one-integration-per-
block design (README.md:2); the oracle is
``ops.golden.baseband2power_scrunch_golden``.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from paf_baseband2power_tpu import constants as C
from paf_baseband2power_tpu.ops import frame as F
from paf_baseband2power_tpu.ops.golden import (
    baseband2power_golden,
    baseband2power_scrunch_golden,
)
from paf_baseband2power_tpu.ops.frame import block_to_rows
from paf_baseband2power_tpu.ops.power import (
    baseband2power_scrunch_2d,
    baseband2power_scrunch_rows,
)

NDF, NCHK = 32, 8
NCHAN = NCHK * C.NCHAN_CHK


def test_scrunch_golden_nout1_equals_power():
    block = F.synthetic_block(rng=0, ndf=NDF, nchk=NCHK)
    got = baseband2power_scrunch_golden(block, 1)
    np.testing.assert_allclose(got[0], baseband2power_golden(block),
                               rtol=1e-6)


def test_scrunch_golden_windows_sum_to_total():
    block = F.synthetic_block(rng=1, ndf=NDF, nchk=NCHK)
    got = baseband2power_scrunch_golden(block, 4)
    np.testing.assert_allclose(got.sum(axis=0),
                               baseband2power_golden(block), rtol=1e-6)


@pytest.mark.parametrize("nout", [1, 4, 32])
def test_scrunch_xla_golden_parity(nout):
    block = F.synthetic_block(rng=2, ndf=NDF, nchk=NCHK)
    want = baseband2power_scrunch_golden(block, nout)
    got = np.asarray(baseband2power_scrunch_2d(
        jnp.asarray(block.reshape(NDF, -1)), nout))
    assert got.shape == (nout, NCHAN)
    np.testing.assert_allclose(got, want, rtol=1e-5)
    got_m = np.asarray(baseband2power_scrunch_2d(
        jnp.asarray(block.reshape(NDF, -1)), nout, mean=True))
    np.testing.assert_allclose(
        got_m, baseband2power_scrunch_golden(block, nout, mean=True),
        rtol=1e-5)


@pytest.mark.parametrize("nout", [1, 2, 4, 8, 16, 32])
def test_scrunch_rows_golden_parity(nout):
    """Rows-layout tscrunch (series rows, one window per frame range)."""
    block = F.synthetic_block(rng=3, ndf=NDF, nchk=NCHK)
    want = baseband2power_scrunch_golden(block, nout)
    got = np.asarray(baseband2power_scrunch_rows(
        jnp.asarray(block_to_rows(block)), nout))
    assert got.shape == (nout, NCHAN)
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("nout", [16, 32, 64])
def test_scrunch_short_windows_taller_block(nout):
    """Short windows on a taller block (8-, 4- and 2-frame windows), both
    layouts, mean mode."""
    ndf = 128
    block = F.synthetic_block(rng=5, ndf=ndf, nchk=NCHK)
    want = baseband2power_scrunch_golden(block, nout, mean=True)
    wire = np.asarray(baseband2power_scrunch_2d(
        jnp.asarray(block.reshape(ndf, -1)), nout, mean=True))
    rows = np.asarray(baseband2power_scrunch_rows(
        jnp.asarray(block_to_rows(block)), nout, mean=True))
    np.testing.assert_allclose(wire, want, rtol=1e-5)
    np.testing.assert_allclose(rows, want, rtol=1e-5)


def test_scrunch_validation():
    block = jnp.zeros((NDF, NCHK * C.DT_SIZE // 2), jnp.int16)
    with pytest.raises(ValueError):
        baseband2power_scrunch_2d(block, 5)  # 5 does not divide 32


def test_scrunch_cli(tmp_path):
    """--nspectra end to end: TSAMP/NSBLK headers, N records per block."""
    import os
    import subprocess
    import sys

    bb = str(tmp_path / "bb.dada")
    out = str(tmp_path / "scrunch.dada")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))))
    subprocess.run(
        [sys.executable, "-m", "paf_baseband2power_tpu.cli.paf_gen",
         "-o", bb, "-n", "2", "--ndf", str(NDF), "--nchk", str(NCHK)],
        env=env, check=True, capture_output=True, timeout=120)
    r = subprocess.run(
        [sys.executable, "-m", "paf_baseband2power_tpu.cli.paf_baseband2power",
         "-a", bb, "-b", out, "-c", str(tmp_path), "--nspectra", "4",
         "--ndf", str(NDF), "--nchk", str(NCHK)],
        env=env, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout + r.stderr

    from paf_baseband2power_tpu.io.dada import DadaFileReader

    rd = DadaFileReader(out)
    assert rd.header["NSBLK"] == "4"
    recs = [np.frombuffer(b, "<f4").reshape(4, NCHAN)
            for b in rd.blocks(4 * NCHAN * 4)]
    rd.close()
    assert len(recs) == 2
    for i, rec in enumerate(recs):
        want = baseband2power_scrunch_golden(
            F.synthetic_block(rng=i, ndf=NDF, nchk=NCHK), 4)
        np.testing.assert_allclose(rec, want, rtol=1e-4)
