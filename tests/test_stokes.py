"""Full-Stokes detection mode (capability extension over the reference's
total-power-only output)."""

import numpy as np
import pytest

import jax.numpy as jnp

from paf_baseband2power_tpu import constants as C
from paf_baseband2power_tpu.ops import frame as F
from paf_baseband2power_tpu.ops.golden import (
    baseband2power_golden,
    baseband2stokes_golden,
)
from paf_baseband2power_tpu.ops.power import baseband2stokes_2d

NDF, NCHK = 16, 8
NCHAN = NCHK * C.NCHAN_CHK


def test_stokes_golden_I_equals_power():
    block = F.synthetic_block(rng=0, ndf=NDF, nchk=NCHK)
    stokes = baseband2stokes_golden(block)
    np.testing.assert_allclose(stokes[0], baseband2power_golden(block),
                               rtol=1e-6)


def test_stokes_jax_golden_parity():
    block = F.synthetic_block(rng=1, ndf=NDF, nchk=NCHK)
    want = baseband2stokes_golden(block)
    got = np.asarray(baseband2stokes_2d(jnp.asarray(block.reshape(NDF, -1))))
    assert got.shape == (4, NCHAN)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-2)
    got_m = np.asarray(
        baseband2stokes_2d(jnp.asarray(block.reshape(NDF, -1)), mean=True))
    np.testing.assert_allclose(
        got_m, baseband2stokes_golden(block, mean=True), rtol=1e-5, atol=1e-4)


def test_stokes_rows_golden_parity():
    """Rows-layout Stokes (adjacent x/y series rows) vs golden, at the
    coarse-mode bound: Q sums per-sample differences, so it carries no
    cancellation of two window-long sums."""
    from paf_baseband2power_tpu.ops.frame import block_to_rows
    from paf_baseband2power_tpu.ops.power import baseband2stokes_scrunch_rows

    block = F.synthetic_block(rng=2, ndf=16, nchk=8)
    rows = jnp.asarray(block_to_rows(block))
    want = baseband2stokes_golden(block)
    got = np.asarray(baseband2stokes_scrunch_rows(rows, 1))[0]
    assert got.shape == (4, NCHAN)
    np.testing.assert_allclose(got, want, rtol=1e-5,
                               atol=1e-6 * np.abs(want).max())
    np.testing.assert_allclose(got[0], want[0], rtol=1e-5)
    got_m = np.asarray(baseband2stokes_scrunch_rows(rows, 1, mean=True))[0]
    want_m = baseband2stokes_golden(block, mean=True)
    np.testing.assert_allclose(got_m, want_m, rtol=1e-5,
                               atol=1e-6 * np.abs(want_m).max())


@pytest.mark.parametrize("layout", ["wire", "wire_scrunch", "rows"])
def test_stokes_q_carries_no_cancellation(layout):
    """Every Stokes path stays near the float32 rounding of its output,
    ~1% of the coarse bound, over 2048 frames. Forming Q as the difference
    of two window-long float32 sums read ~5% of it here, and ~11% over a
    full 8192 x 48 block."""
    from paf_baseband2power_tpu.ops.golden import (
        baseband2stokes_scrunch_golden,
    )
    from paf_baseband2power_tpu.ops.power import (
        baseband2stokes_scrunch_2d,
        baseband2stokes_scrunch_rows,
    )

    ndf, nout = 2048, 2
    block = F.synthetic_block(rng=0, ndf=ndf, nchk=1)
    want = baseband2stokes_scrunch_golden(block, nout)
    if layout == "rows":
        got = baseband2stokes_scrunch_rows(
            jnp.asarray(F.block_to_rows(block)), nout)
    elif layout == "wire_scrunch":
        got = baseband2stokes_scrunch_2d(jnp.asarray(block.reshape(ndf, -1)),
                                         nout)
    else:
        got, want = (baseband2stokes_2d(jnp.asarray(block.reshape(ndf, -1))),
                     baseband2stokes_golden(block))
    diff = np.abs(np.asarray(got, np.float64) - want)
    bound = 1e-5 * np.abs(want) + 1e-6 * np.abs(want).max()
    assert (diff / bound).max() < 0.025


def test_stokes_polarization_physics():
    """Constructed polarization states land in the right parameters."""
    rng = np.random.default_rng(3)
    shape = (NDF, NCHK, C.NSAMP_DF, C.NCHAN_CHK)
    xr = rng.integers(-100, 100, size=shape).astype(np.int16)
    xi = rng.integers(-100, 100, size=shape).astype(np.int16)

    def build(yr, yi):
        b = np.zeros(shape + (2, 2), np.int16)
        b[..., 0, 0], b[..., 0, 1] = xr, xi
        b[..., 1, 0], b[..., 1, 1] = yr, yi
        return b

    # y = x: fully linearly polarized -> Q = 0, U = I, V = 0
    s = baseband2stokes_golden(build(xr, xi))
    np.testing.assert_allclose(s[1], 0, atol=1e-3)
    np.testing.assert_allclose(s[2], s[0], rtol=1e-6)
    np.testing.assert_allclose(s[3], 0, atol=1e-3)
    # y = i x: fully circular -> Q = 0, U = 0, V = -I
    #   (x y* = x (ix)* = -i |x|^2 -> Im = -|x|^2)
    s = baseband2stokes_golden(build(-xi, xr))
    np.testing.assert_allclose(s[1], 0, atol=1e-3)
    np.testing.assert_allclose(s[2], 0, atol=1e-3)
    np.testing.assert_allclose(s[3], -s[0], rtol=1e-6)
    # y = 0: horizontal -> Q = I, U = V = 0
    s = baseband2stokes_golden(build(np.zeros_like(xr), np.zeros_like(xi)))
    np.testing.assert_allclose(s[1], s[0], rtol=1e-6)
    np.testing.assert_allclose(s[2], 0, atol=1e-3)


def test_stokes_pipeline_and_cli(tmp_path):
    """--stokes end to end: NPOL 4 header, 4*nchan records, golden parity."""
    import subprocess
    import sys
    import os

    bb = str(tmp_path / "bb.dada")
    out = str(tmp_path / "stokes.dada")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               PYTHONPATH=os.path.dirname(os.path.dirname(
                   os.path.abspath(__file__))))
    r = subprocess.run(
        [sys.executable, "-m", "paf_baseband2power_tpu.cli.paf_gen",
         "-o", bb, "-n", "2", "--ndf", str(NDF), "--nchk", str(NCHK)],
        env=env, capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    r = subprocess.run(
        [sys.executable, "-m", "paf_baseband2power_tpu.cli.paf_baseband2power",
         "-a", bb, "-b", out, "-c", str(tmp_path), "--stokes",
         "--ndf", str(NDF), "--nchk", str(NCHK), "--debug"],
        env=env, capture_output=True, text=True, timeout=240)
    assert r.returncode == 0, r.stdout + r.stderr

    from paf_baseband2power_tpu.io.dada import DadaFileReader

    rd = DadaFileReader(out)
    assert rd.header["NPOL"] == "4"
    assert rd.header["STOKES"] == "IQUV"
    recs = [np.frombuffer(b, "<f4").reshape(4, NCHAN)
            for b in rd.blocks(4 * NCHAN * 4)]
    rd.close()
    assert len(recs) == 2
    # paf_gen writes deterministic synthetic blocks seeded by index
    for i, rec in enumerate(recs):
        want = baseband2stokes_golden(
            F.synthetic_block(rng=i, ndf=NDF, nchk=NCHK))
        np.testing.assert_allclose(rec, want, rtol=1e-4, atol=1e-2)
