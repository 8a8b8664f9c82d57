"""JAX compute-path parity tests vs the NumPy golden model."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from paf_baseband2power_tpu import constants as C
from paf_baseband2power_tpu.ops import frame as F
from paf_baseband2power_tpu.ops.golden import baseband2power_golden
from paf_baseband2power_tpu.ops import power as P


@pytest.fixture(scope="module")
def small_block():
    return F.synthetic_block(rng=11, ndf=32, nchk=C.NCHK_NIC)


def test_power_matches_golden(small_block):
    got = np.asarray(P.baseband2power(jnp.asarray(small_block)))
    want = baseband2power_golden(small_block)
    assert got.shape == (C.NCHAN,)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_power_mean_mode(small_block):
    got = np.asarray(P.baseband2power(jnp.asarray(small_block), mean=True))
    want = baseband2power_golden(small_block, mean=True)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_power_from_raw_bytes(small_block):
    raw = np.frombuffer(F.block_to_bytes(small_block), dtype=np.uint8)
    got = np.asarray(
        P.baseband2power_bytes(jnp.asarray(raw), ndf=32, nchk=C.NCHK_NIC)
    )
    want = baseband2power_golden(small_block)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_bytes_to_block_device_roundtrip(small_block):
    raw = np.frombuffer(F.block_to_bytes(small_block), dtype=np.uint8)
    back = np.asarray(P.bytes_to_block_device(jnp.asarray(raw), 32, C.NCHK_NIC))
    np.testing.assert_array_equal(back, small_block)


def test_unpack_voltage():
    block = F.synthetic_block(rng=2, ndf=4, nchk=2)
    v = np.asarray(P.unpack_voltage(jnp.asarray(block)))
    assert v.dtype == np.complex64
    np.testing.assert_array_equal(v.real, block[..., 0].astype(np.float32))
    np.testing.assert_array_equal(v.imag, block[..., 1].astype(np.float32))


def test_power_extreme_values():
    """Full-scale int16 voltages must not overflow the f32 accumulation
    at test scale."""
    block = np.full((16, 2, C.NSAMP_DF, C.NCHAN_CHK, 2, 2), -32768, np.int16)
    got = np.asarray(P.baseband2power(jnp.asarray(block)))
    want = baseband2power_golden(block)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_power_full_block_precision():
    """Full 8192-frame integration in f32 stays within 1e-5 of float64.

    Uses the real frame count with a reduced chunk count to keep the test
    fast while exercising the full 2^20-sample accumulation depth.
    """
    block = F.synthetic_block(rng=5, ndf=C.NDF_BLK, nchk=1)
    got = np.asarray(P.baseband2power(jnp.asarray(block)))
    want = baseband2power_golden(block)
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_power_jit_cache():
    """Repeated calls with the same shape must not retrace."""
    block = jnp.asarray(F.synthetic_block(rng=1, ndf=8, nchk=2))
    x2d = block.reshape(8, -1)
    P.baseband2power_2d(x2d)
    n0 = P.baseband2power_2d._cache_size()
    P.baseband2power_2d(x2d + 1)
    assert P.baseband2power_2d._cache_size() == n0


# ---------------------------------------------------------------------------
# 2-D wire device layout (ndf, nchk*3584): the production power step
# ---------------------------------------------------------------------------

def test_wire_2d_layout_is_view(small_block):
    b2 = small_block.reshape(32, -1)
    assert b2.shape == (32, C.NCHK_NIC * C.LANES_PER_CHUNK)
    assert np.shares_memory(b2, small_block)   # zero copy


def test_power_2d_matches_golden(small_block):
    got = np.asarray(P.baseband2power_2d(jnp.asarray(
        small_block.reshape(32, -1))))
    assert got.shape == (C.NCHAN,)
    np.testing.assert_allclose(got, baseband2power_golden(small_block),
                               rtol=1e-5)


def test_power_2d_mean(small_block):
    got = np.asarray(P.baseband2power_2d(
        jnp.asarray(small_block.reshape(32, -1)), mean=True))
    np.testing.assert_allclose(
        got, baseband2power_golden(small_block, mean=True), rtol=1e-5)


def test_power_2d_from_ring_bytes(small_block):
    """Ring-block bytes viewed as the 2-D layout (what RingSource and
    FileSource hand the pipeline) integrate like the canonical block."""
    raw = F.block_to_bytes(small_block)
    b2 = np.frombuffer(raw, dtype="<i2").reshape(32, -1)
    got = np.asarray(P.baseband2power_2d(jnp.asarray(b2)))
    np.testing.assert_allclose(got, baseband2power_golden(small_block),
                               rtol=1e-5)


def test_power_2d_small_chunk_counts():
    """Reduced-geometry blocks (nchk not 48) still work."""
    block = F.synthetic_block(rng=5, ndf=16, nchk=4)
    got = np.asarray(P.baseband2power_2d(jnp.asarray(block.reshape(16, -1))))
    np.testing.assert_allclose(got, baseband2power_golden(block), rtol=1e-5)


def test_power_2d_rejects_bad_lanes():
    with pytest.raises(ValueError):
        P.baseband2power_2d(jnp.zeros((16, 100), jnp.int16))
    with pytest.raises(ValueError):
        P.baseband2power_scrunch_2d(
            jnp.zeros((16, C.LANES_PER_CHUNK + 1), jnp.int16), 2)


def test_power_2d_any_frame_count():
    """No tiling constraint on the frame axis: 12 frames integrate."""
    block = F.synthetic_block(rng=6, ndf=12, nchk=2)
    got = np.asarray(P.baseband2power_2d(jnp.asarray(block.reshape(12, -1))))
    np.testing.assert_allclose(got, baseband2power_golden(block), rtol=1e-5)
