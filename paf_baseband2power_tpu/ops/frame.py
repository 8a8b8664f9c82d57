"""BMF data-frame codec and synthetic frame generation.

The PAF beamformer emits 7232-byte UDP frames: a 64-byte header of big-endian
64-bit words followed by 7168 bytes of int16 I/Q voltage payload. The header
bit layout replicated here follows the reference decoder semantics
(``hdr.c:10-28``):

* word 0: bit 63 ``valid``; bits 61:32 ``sec`` (seconds since period start,
  30-bit field); bits 31:0 ``idf`` (frame index within the 27 s period).
* word 1: bits 31:26 ``epoch`` (half-years since 2000-01-01).
* word 2: bits 31:16 ``freq`` (first channel frequency of the chunk, MHz);
  bits 15:0 ``beam`` id.

The payload layout is [sample (128)][channel (7)][pol (2)][I,Q int16],
little-endian — the TFP-within-frame ordering implied by the reference's
TFTFP ring-block layout (``capture.c:540-544``). The reference never shipped
its unpack kernel, so payload endianness/order is fixed here as the framework
contract and used consistently by the generator, golden model, and kernels.
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import os

import numpy as np

from ..constants import (
    DF_SIZE,
    DT_SIZE,
    HDR_SIZE,
    NCHAN_CHK,
    NCHK_NIC,
    NDF_BLK,
    NDF_PRD,
    NDIM_POL,
    NPOL_SAMP,
    NSAMP_DF,
)

FRAME_PAYLOAD_SHAPE = (NSAMP_DF, NCHAN_CHK, NPOL_SAMP, NDIM_POL)
PAYLOAD_DTYPE = np.dtype("<i2")


@dataclasses.dataclass
class FrameHeader:
    """Decoded BMF frame header (mirrors ``hdr_t``, ``hdr.h:6-14``)."""

    valid: int = 0
    idf: int = 0          # data-frame index within the 27 s period
    sec: int = 0          # seconds from epoch to period start
    epoch: int = 0        # half-years since 2000-01-01
    beam: int = 0
    freq: float = 0.0     # first channel of the chunk, integer MHz

    def pack(self) -> bytes:
        """Encode to the 64-byte big-endian wire format."""
        w = np.zeros(HDR_SIZE // 8, dtype=">u8")
        w[0] = (
            ((self.valid & 0x1) << 63)
            | ((self.sec & 0x3FFFFFFF) << 32)
            | (self.idf & 0xFFFFFFFF)
        )
        w[1] = (self.epoch & 0x3F) << 26
        w[2] = ((int(self.freq) & 0xFFFF) << 16) | (self.beam & 0xFFFF)
        return w.tobytes()

    @classmethod
    def unpack(cls, buf: bytes | memoryview | np.ndarray) -> "FrameHeader":
        """Decode from the first 64 bytes of a frame (``hdr.c:10-28``)."""
        w = np.frombuffer(buf, dtype=">u8", count=HDR_SIZE // 8)
        w0, w1, w2 = int(w[0]), int(w[1]), int(w[2])
        return cls(
            valid=(w0 >> 63) & 0x1,
            sec=(w0 >> 32) & 0x3FFFFFFF,
            idf=w0 & 0xFFFFFFFF,
            epoch=(w1 >> 26) & 0x3F,
            freq=float((w2 >> 16) & 0xFFFF),
            beam=w2 & 0xFFFF,
        )


def header_idf(buf) -> int:
    """Fast path for the frame index (``hdr_idf``, ``hdr.c:30-37``)."""
    w0 = int(np.frombuffer(buf, dtype=">u8", count=1)[0])
    return w0 & 0xFFFFFFFF


def header_sec(buf) -> int:
    w0 = int(np.frombuffer(buf, dtype=">u8", count=1)[0])
    return (w0 >> 32) & 0x3FFFFFFF


def frame_distance(hdr: FrameHeader, ref: FrameHeader) -> int:
    """Signed frame count from ``ref`` to ``hdr``, wrap-aware.

    Replicates ``acquire_idf`` (``capture.c:562-568``): distance in frames
    including the seconds field (sec deltas are multiples of the 27 s period,
    so ``dsec * NDF_PRD / 27`` is exact), letting frames from the next period
    order correctly after the current one.
    """
    return (hdr.idf - ref.idf) + (hdr.sec - ref.sec) * NDF_PRD // 27


def advance_ref(ref: FrameHeader, ndf: int) -> FrameHeader:
    """Advance a reference header by ``ndf`` frames with 27 s wraparound.

    Mirrors the sync thread's block rotation (``sync.c:115-127``).
    """
    idf = ref.idf + ndf
    sec = ref.sec
    while idf >= NDF_PRD:
        idf -= NDF_PRD
        sec += 27
    return dataclasses.replace(ref, idf=idf, sec=sec)


def build_frame(hdr: FrameHeader, payload: np.ndarray) -> bytes:
    """Assemble one 7232-byte wire frame."""
    payload = np.ascontiguousarray(payload, dtype=PAYLOAD_DTYPE)
    if payload.nbytes != DT_SIZE:
        raise ValueError(f"payload must be {DT_SIZE} bytes, got {payload.nbytes}")
    return hdr.pack() + payload.tobytes()


def split_frame(frame: bytes | memoryview) -> tuple[FrameHeader, np.ndarray]:
    """Decode one wire frame into (header, payload[int16 view])."""
    if len(frame) != DF_SIZE:
        raise ValueError(f"frame must be {DF_SIZE} bytes, got {len(frame)}")
    hdr = FrameHeader.unpack(frame)
    payload = np.frombuffer(frame, dtype=PAYLOAD_DTYPE, offset=HDR_SIZE).reshape(
        FRAME_PAYLOAD_SHAPE
    )
    return hdr, payload


def _each_chunk(fn, nchk: int, nbytes: int) -> None:
    """Run ``fn(c)`` for every chunk ``c`` — on threads for blocks of
    ``nbytes`` >= 64 MiB: NumPy's generators and copies release the GIL,
    and a full block is 2.8 GB."""
    workers = min(nchk, os.cpu_count() or 1) if nbytes >= 1 << 26 else 1
    if workers <= 1:
        for c in range(nchk):
            fn(c)
        return
    with concurrent.futures.ThreadPoolExecutor(workers) as pool:
        list(pool.map(fn, range(nchk)))


def synthetic_block(
    rng: np.random.Generator | int | None = 0,
    ndf: int = NDF_BLK,
    nchk: int = NCHK_NIC,
    scale: float = 64.0,
    dtype=np.int16,
) -> np.ndarray:
    """Generate a synthetic baseband ring-buffer block.

    Returns int16 voltages of shape ``(ndf, nchk, NSAMP_DF, NCHAN_CHK,
    NPOL_SAMP, NDIM_POL)`` — the TFTFP block layout the capture stage writes
    (``capture.c:540-544``). Gaussian noise at ``scale`` LSB rms approximates
    beamformed sky noise. Each chunk draws from its own stream spawned from
    ``rng`` (an int seed gives the same block every time; a Generator is
    advanced by one draw), so chunks generate in parallel.
    """
    if isinstance(rng, np.random.Generator):
        rng = int(rng.integers(2 ** 63))
    seeds = np.random.SeedSequence(rng).spawn(nchk)
    out = np.empty((ndf, nchk, NSAMP_DF, NCHAN_CHK, NPOL_SAMP, NDIM_POL),
                   dtype)

    def chunk(c: int) -> None:
        x = np.random.default_rng(seeds[c]).normal(
            0.0, scale, size=(ndf,) + out.shape[2:])
        out[:, c] = np.clip(np.rint(x), -32768, 32767)

    _each_chunk(chunk, nchk, out.nbytes)
    return out


def block_to_bytes(block: np.ndarray) -> bytes:
    """Serialize a block array to the ring-buffer wire layout (C order)."""
    return np.ascontiguousarray(block, dtype=PAYLOAD_DTYPE).tobytes()


def bytes_to_block(buf, ndf: int = NDF_BLK, nchk: int = NCHK_NIC) -> np.ndarray:
    """View ring-buffer bytes as the canonical block array (zero copy)."""
    shape = (ndf, nchk, NSAMP_DF, NCHAN_CHK, NPOL_SAMP, NDIM_POL)
    return np.frombuffer(buf, dtype=PAYLOAD_DTYPE).reshape(shape)


def block_to_rows(block: np.ndarray) -> np.ndarray:
    """Canonical 6-D block -> series rows ``(nseries, ndf, 256) int16``.

    The host corner turn of ``capture --device-layout`` (AVX2 in the
    native engine; this is the numpy reference): one row per
    (chunk, channel, pol) series, 256-lane frame segments with re/im
    interleaved on lanes. Single source of truth for every producer of
    the rows layout (paf_gen, paf_relayout, multihost feeders, tests).
    """
    ndf, nchk = block.shape[0], block.shape[1]
    per = NCHAN_CHK * NPOL_SAMP
    out = np.empty((nchk, NCHAN_CHK, NPOL_SAMP, ndf, NSAMP_DF, NDIM_POL),
                   block.dtype)

    def chunk(c: int) -> None:
        out[c] = block[:, c].transpose(2, 3, 0, 1, 4)

    _each_chunk(chunk, nchk, block.nbytes)
    return out.reshape(nchk * per, ndf, 2 * NSAMP_DF)


def rows_to_block(rows: np.ndarray, ndf: int, nchk: int) -> np.ndarray:
    """Inverse of :func:`block_to_rows` (series rows -> canonical 6-D)."""
    r6 = rows.reshape(nchk, NCHAN_CHK, NPOL_SAMP, ndf, NSAMP_DF, 2)
    return np.ascontiguousarray(r6.transpose(3, 0, 4, 1, 2, 5))
