"""UDP capture engine tests over localhost loopback.

The software-BMF sender streams real wire-format frames into the native
capture engine; assertions check TFTFP block placement, reorder tolerance,
loss accounting, and stream-start metadata.
"""

import threading
import uuid

import numpy as np
import pytest

from paf_baseband2power_tpu import constants as C
from paf_baseband2power_tpu.io import ringbuffer as rb
from paf_baseband2power_tpu.io.capture import CaptureConf, CaptureEngine
from paf_baseband2power_tpu.io.sender import stream_frames

NDF = 32          # frames per block
NCHK = 8          # chunks
NPORTS = 2
FREQ0 = 1000.0


def expected_payload(k, ichk):
    base = (k * 131 + ichk * 17) % 251
    return ((np.arange(C.DT_SIZE // 2, dtype=np.int16) % 199) + base)


@pytest.fixture
def ring_key():
    key = uuid.uuid4().hex[:8]
    rb.create(key, NDF * NCHK * C.DT_SIZE, 4)
    yield key
    if rb.exists(key):
        rb.destroy(key)


def _free_ports():
    """Pick a base port with NPORTS consecutive free UDP ports."""
    import socket as pysock
    for base in range(27100, 27900, 10):
        socks = []
        try:
            for i in range(NPORTS):
                s = pysock.socket(pysock.AF_INET, pysock.SOCK_DGRAM)
                s.bind(("127.0.0.1", base + i))
                socks.append(s)
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise RuntimeError("no free ports")


def run_capture(ring_key, nframes, port_base, probe_frames=NCHK * 2,
                sender_kwargs=None, nblocks_expect=None, idf0=0,
                length_sec=0.0, device_layout=False):
    """Start the engine, stream frames at it, wait for completion."""
    conf = CaptureConf(
        ip="127.0.0.1", port_base=port_base, nports=NPORTS,
        ring_key=ring_key, ndf_blk=NDF, nchk=NCHK, freq_base=FREQ0,
        chunk_bw=7.0, tbuf_ndf=16, timeout_sec=1.5, ndf_check=probe_frames,
        length_sec=length_sec, zero_blocks=True,
        device_layout=device_layout,
    )
    eng = CaptureEngine(conf)
    kw = dict(host="127.0.0.1", port_base=port_base, nports=NPORTS,
              nchk=NCHK, freq_base=FREQ0, chunk_bw=7.0, epoch=51,
              sec0=27, idf0=idf0)
    kw.update(sender_kwargs or {})

    # Probe warmup: repeat the same idf window until the probe has had
    # enough (bind order vs first send is racy on loopback; identical idfs
    # keep the resulting reference frame deterministic).
    probe_done = threading.Event()

    def probe_feed():
        while not probe_done.is_set():
            stream_frames(**dict(kw, nframes=probe_frames, pace_sec=0.0005,
                                 drop_prob=0.0, shuffle_window=0))

    probe_tx = threading.Thread(target=probe_feed)
    probe_tx.start()
    try:
        nports = eng.probe()
    finally:
        probe_done.set()
        probe_tx.join()
    assert nports == NPORTS
    eng.start()

    # The engine aligned to (last frame the probe saw) + 1 — query it rather
    # than assuming how far the probe got before its early-stop. Leftover
    # probe-round frames may still arrive; their payloads are keyed by the
    # same global frame index, so placement checks stay exact (only the
    # received counters can overcount).
    main_idf0 = eng.ref_idf
    tx = threading.Thread(target=stream_frames, kwargs=dict(
        kw, idf0=main_idf0, nframes=nframes, pace_sec=0.0005))
    tx.start()
    tx.join()
    rc = eng.wait()  # engine finishes on 1.5 s socket silence
    return eng, rc, main_idf0


def read_blocks(ring_key):
    blocks = []
    with rb.RingBuffer(ring_key) as ring:
        ring.lock_read()
        while True:
            view = ring.open_block_read(timeout_us=2_000_000)
            if view is None:
                break
            blocks.append(view.copy())
            ring.close_block_read()
        ring.unlock_read()
    return blocks


def test_capture_clean_stream(ring_key):
    """In-order lossless stream: every frame lands at its TFTFP slot."""
    port_base = _free_ports()
    eng, rc, idf0 = run_capture(ring_key, nframes=2 * NDF,
                                port_base=port_base)
    assert rc == 0
    assert eng.active_chunks == NCHK
    assert eng.blocks_committed >= 2
    stats = eng.port_stats()
    recv = sum(s.received for s in stats)
    assert recv >= 2 * NDF * NCHK  # dup probe leftovers may overcount
    eng.close()

    blocks = read_blocks(ring_key)
    assert len(blocks) >= 2
    for bi in range(2):
        arr = blocks[bi].view("<i2").reshape(NDF, NCHK, C.DT_SIZE // 2)
        for t in (0, NDF // 2, NDF - 1):
            for c in (0, NCHK - 1):
                k = idf0 + bi * NDF + t
                np.testing.assert_array_equal(
                    arr[t, c], expected_payload(k, c),
                    err_msg=f"block {bi} frame {t} chunk {c}")


def test_capture_reordered_stream(ring_key):
    """Frames shuffled within a window still land correctly (temp buffer)."""
    port_base = _free_ports()
    eng, rc, idf0 = run_capture(
        ring_key, nframes=2 * NDF, port_base=port_base,
        sender_kwargs=dict(shuffle_window=8, seed=3))
    assert rc == 0
    eng.close()
    blocks = read_blocks(ring_key)
    assert len(blocks) >= 2
    arr = blocks[0].view("<i2").reshape(NDF, NCHK, C.DT_SIZE // 2)
    for t in range(0, NDF, 5):
        for c in range(NCHK):
            np.testing.assert_array_equal(
                arr[t, c], expected_payload(idf0 + t, c))


def test_capture_lossy_stream_statistics(ring_key):
    """Dropped frames leave zero-filled slots and show up in accounting."""
    port_base = _free_ports()
    eng, rc, _ = run_capture(
        ring_key, nframes=2 * NDF, port_base=port_base,
        sender_kwargs=dict(drop_prob=0.2, seed=7))
    assert rc == 0
    total_exp = sum(s.expected for s in eng.port_stats())
    assert total_exp > 0
    eng.close()

    # data-level loss: blocks are zero-filled, so missing frames are
    # all-zero slots (element 1 of a real payload is always nonzero)
    blocks = read_blocks(ring_key)
    assert len(blocks) >= 2
    filled = 0
    for bi in range(2):
        arr = blocks[bi].view("<i2").reshape(NDF, NCHK, C.DT_SIZE // 2)
        filled += int(np.count_nonzero(arr[:, :, 1]))
    loss = 1 - filled / (2 * NDF * NCHK)
    assert 0.05 < loss < 0.4


def test_capture_length_limit(ring_key):
    """-j length: capture stops after the configured stream time."""
    port_base = _free_ports()
    # length = 1 block of stream time
    eng, rc, _ = run_capture(ring_key, nframes=4 * NDF, port_base=port_base,
                             length_sec=NDF * C.TDF_SEC)
    assert rc == 0
    # only ~1 block's worth of frames accepted per port (plus probe
    # leftovers and the boundary frame)
    recv = sum(s.received for s in eng.port_stats())
    assert recv <= NDF * NCHK + NCHK + 2 * NDF * NCHK // 4
    assert recv < 2 * NDF * NCHK  # far fewer than the 4 blocks streamed
    eng.close()


def test_capture_start_metadata(ring_key):
    port_base = _free_ports()
    eng, rc, idf0 = run_capture(ring_key, nframes=NDF, port_base=port_base)
    assert eng.epoch == 51
    # reference = (some probe frame) + 1, within the probe window
    assert 0 < eng.ref_idf <= NCHK * 2
    assert eng.ref_idf == idf0
    assert eng.ref_sec == 27
    assert eng.freq_center == pytest.approx(FREQ0 + 7.0 * (NCHK - 1) / 2)
    eng.close()


def test_capture_port_elapsed(ring_key):
    """Per-port elapsed time (capture.c:450,552) is recorded."""
    port_base = _free_ports()
    eng, rc, _ = run_capture(ring_key, nframes=2 * NDF, port_base=port_base)
    assert rc == 0
    for st in eng.port_stats():
        assert st.elapsed > 0.0
    eng.close()


def test_capture_invalid_frames_rejected(ring_key):
    """Frames with a cleared valid bit are rejected and counted
    (hdr.c:15-16)."""
    port_base = _free_ports()
    eng, rc, idf0 = run_capture(
        ring_key, nframes=2 * NDF, port_base=port_base,
        sender_kwargs=dict(invalid_prob=0.25, seed=11))
    assert rc == 0
    stats = eng.port_stats()
    ninvalid = sum(s.invalid for s in stats)
    assert ninvalid > 0
    eng.close()
    # invalid frames never land in the block: their slots stay zero, like
    # dropped frames (zero_blocks), and valid ones are still bit-exact
    blocks = read_blocks(ring_key)
    assert len(blocks) >= 2
    arr = blocks[0].view("<i2").reshape(NDF, NCHK, C.DT_SIZE // 2)
    nzero = sum(1 for t in range(NDF) for c in range(NCHK)
                if arr[t, c, 1] == 0)
    assert nzero > 0  # some invalidated slots
    filled_checked = 0
    for t in range(NDF):
        for c in range(NCHK):
            if arr[t, c, 1] != 0:
                np.testing.assert_array_equal(
                    arr[t, c], expected_payload(idf0 + t, c))
                filled_checked += 1
    assert filled_checked > 0


def test_capture_native_sender_parity(ring_key):
    """The C++ sendmmsg sender produces the identical wire stream: capture
    places its frames bit-exactly where the Python sender's land."""
    import threading

    from paf_baseband2power_tpu.io.sender import stream_frames_native

    port_base = _free_ports()
    conf = CaptureConf(
        ip="127.0.0.1", port_base=port_base, nports=NPORTS,
        ring_key=ring_key, ndf_blk=NDF, nchk=NCHK, freq_base=FREQ0,
        chunk_bw=7.0, tbuf_ndf=16, timeout_sec=1.5, ndf_check=NCHK * 2,
        zero_blocks=True,
    )
    eng = CaptureEngine(conf)
    kw = dict(host="127.0.0.1", port_base=port_base, nports=NPORTS,
              nchk=NCHK, freq_base=FREQ0, chunk_bw=7.0, epoch=51, sec0=27)

    probe_done = threading.Event()

    def probe_feed():
        while not probe_done.is_set():
            stream_frames(**dict(kw, idf0=0, nframes=NCHK * 2,
                                 pace_sec=0.0005))

    tx0 = threading.Thread(target=probe_feed)
    tx0.start()
    try:
        assert eng.probe() == NPORTS
    finally:
        probe_done.set()
        tx0.join()
    eng.start()
    idf0 = eng.ref_idf
    # gentle pacing (100x real time of this tiny geometry) so loopback
    # receive buffers never overflow; parity is the point here, rate is
    # benchmarked in the soak
    sent = stream_frames_native(**kw, idf0=idf0, nframes=2 * NDF, rate=0.02)
    assert sent == 2 * NDF * NCHK
    rc = eng.wait()
    assert rc == 0
    eng.close()

    blocks = read_blocks(ring_key)
    assert len(blocks) >= 2
    for bi in range(2):
        arr = blocks[bi].view("<i2").reshape(NDF, NCHK, C.DT_SIZE // 2)
        for t in (0, NDF - 1):
            for c in (0, NCHK - 1):
                k = idf0 + bi * NDF + t
                np.testing.assert_array_equal(
                    arr[t, c], expected_payload(k, c),
                    err_msg=f"block {bi} frame {t} chunk {c}")


def test_capture_force_switch(ring_key):
    """Graceful data loss (capture.c:510-524, design note 471-488): a frame
    too far ahead for the temp buffer forces a block switch instead of a
    stall; capture continues and later frames land correctly."""
    port_base = _free_ports()
    conf = CaptureConf(
        ip="127.0.0.1", port_base=port_base, nports=NPORTS,
        ring_key=ring_key, ndf_blk=NDF, nchk=NCHK, freq_base=FREQ0,
        chunk_bw=7.0, tbuf_ndf=16, timeout_sec=1.5, ndf_check=NCHK * 2,
        zero_blocks=True,
    )
    eng = CaptureEngine(conf)
    kw = dict(host="127.0.0.1", port_base=port_base, nports=NPORTS,
              nchk=NCHK, freq_base=FREQ0, chunk_bw=7.0, epoch=51, sec0=27)

    probe_done = threading.Event()

    def probe_feed():
        while not probe_done.is_set():
            stream_frames(**dict(kw, idf0=0, nframes=NCHK * 2,
                                 pace_sec=0.0005))

    tx0 = threading.Thread(target=probe_feed)
    tx0.start()
    try:
        eng.probe()
    finally:
        probe_done.set()
        tx0.join()
    eng.start()
    idf0 = eng.ref_idf

    # a few in-window frames, then a jump past the temp buffer but short of
    # the quit threshold: ndf + tbuf_ndf <= rel < 2*ndf
    stream_frames(**dict(kw, idf0=idf0, nframes=4, pace_sec=0.0005))
    jump = NDF + 16 + 4   # rel in [ndf+tbuf, 2*ndf)
    assert NDF + 16 <= jump < 2 * NDF
    stream_frames(**dict(kw, idf0=idf0 + jump, nframes=2, pace_sec=0.0005))
    # after the forced rotation the stream continues in the NEXT block's
    # window; these frames must land normally
    stream_frames(**dict(kw, idf0=idf0 + NDF, nframes=4, pace_sec=0.0005))
    rc = eng.wait()
    assert rc == 0                      # force-switch is NOT fatal
    assert eng.force_switches >= 1
    assert eng.blocks_committed >= 2    # rotation happened
    eng.close()

    blocks = read_blocks(ring_key)
    assert len(blocks) >= 2
    # post-switch frames landed in block 1 at their TFTFP slots
    arr = blocks[1].view("<i2").reshape(NDF, NCHK, C.DT_SIZE // 2)
    for t in range(2):
        for c in (0, NCHK - 1):
            np.testing.assert_array_equal(
                arr[t, c], expected_payload(idf0 + NDF + t, c))


def test_capture_fall_behind_quit(ring_key):
    """Unrecoverable fall-behind (capture.c:491-509): a frame a full extra
    block ahead quits the engine; wait() reports it and EOD is still set so
    downstream readers terminate."""
    port_base = _free_ports()
    conf = CaptureConf(
        ip="127.0.0.1", port_base=port_base, nports=NPORTS,
        ring_key=ring_key, ndf_blk=NDF, nchk=NCHK, freq_base=FREQ0,
        chunk_bw=7.0, tbuf_ndf=16, timeout_sec=1.5, ndf_check=NCHK * 2,
        zero_blocks=True,
    )
    eng = CaptureEngine(conf)
    kw = dict(host="127.0.0.1", port_base=port_base, nports=NPORTS,
              nchk=NCHK, freq_base=FREQ0, chunk_bw=7.0, epoch=51, sec0=27)

    probe_done = threading.Event()

    def probe_feed():
        while not probe_done.is_set():
            stream_frames(**dict(kw, idf0=0, nframes=NCHK * 2,
                                 pace_sec=0.0005))

    tx0 = threading.Thread(target=probe_feed)
    tx0.start()
    try:
        eng.probe()
    finally:
        probe_done.set()
        tx0.join()
    eng.start()
    idf0 = eng.ref_idf

    stream_frames(**dict(kw, idf0=idf0, nframes=2, pace_sec=0.0005))
    # a frame >= 2 blocks ahead of the current window: fatal
    stream_frames(**dict(kw, idf0=idf0 + 2 * NDF + 1, nframes=1,
                         pace_sec=0.0005))
    rc = eng.wait()
    assert rc == 1   # quit, the reference's unrecoverable policy
    eng.close()

    # EOD was signalled on the quit path (sync.c:184,196 contract): a
    # reader drains whatever was committed and terminates instead of
    # hanging
    blocks = read_blocks(ring_key)
    assert isinstance(blocks, list)


def test_capture_beam_filter(ring_key):
    """beam filter: frames from other beams are rejected as invalid."""
    port_base = _free_ports()
    conf = CaptureConf(
        ip="127.0.0.1", port_base=port_base, nports=NPORTS,
        ring_key=ring_key, ndf_blk=NDF, nchk=NCHK, freq_base=FREQ0,
        chunk_bw=7.0, tbuf_ndf=16, timeout_sec=1.5, ndf_check=NCHK * 2,
        beam=3, zero_blocks=True,
    )
    eng = CaptureEngine(conf)
    kw = dict(host="127.0.0.1", port_base=port_base, nports=NPORTS,
              nchk=NCHK, freq_base=FREQ0, chunk_bw=7.0, epoch=51, sec0=27)

    probe_done = threading.Event()

    def probe_feed():
        while not probe_done.is_set():
            stream_frames(**dict(kw, idf0=0, nframes=NCHK * 2, beam=3,
                                 pace_sec=0.0005))

    tx0 = threading.Thread(target=probe_feed)
    tx0.start()
    try:
        eng.probe()
    finally:
        probe_done.set()
        tx0.join()
    eng.start()
    idf0 = eng.ref_idf
    # interleave the wanted beam with another beam
    stream_frames(**dict(kw, idf0=idf0, nframes=NDF, beam=3,
                         pace_sec=0.0005))
    stream_frames(**dict(kw, idf0=idf0, nframes=NDF, beam=5,
                         pace_sec=0.0005))
    rc = eng.wait()
    assert rc == 0
    stats = eng.port_stats()
    # all beam-5 frames rejected: dropped >= one full stream's worth
    assert sum(s.dropped for s in stats) >= NDF * NCHK
    eng.close()


def test_capture_zero_fill_after_ring_wrap():
    """Zero-on-loss holds on RECYCLED ring memory.

    Rotation no longer memsets whole blocks under the rotation lock (the
    old design stalled every capture thread for the duration of a 2.8 GB
    memset at full geometry); instead unfilled slots are zeroed from a
    fill-tag scan just before the block is committed. The regression this
    guards: a block whose shm memory previously held real frames (ring
    wrapped, nbufs=2, 6 blocks streamed) must still read zeros — not stale
    bytes from the earlier cycle — at every lost slot.
    """
    key = uuid.uuid4().hex[:8]
    rb.create(key, NDF * NCHK * C.DT_SIZE, 2)
    blocks = []

    def reader():
        with rb.RingBuffer(key) as ring:
            ring.lock_read()
            while True:
                view = ring.open_block_read(timeout_us=20_000_000)
                if view is None:
                    break
                blocks.append(view.copy())
                ring.close_block_read()
            ring.unlock_read()

    rx = threading.Thread(target=reader)
    rx.start()
    try:
        port_base = _free_ports()
        eng, rc, idf0 = run_capture(
            key, nframes=6 * NDF, port_base=port_base,
            sender_kwargs=dict(drop_prob=0.25, seed=11))
        assert rc == 0
        eng.close()
        rx.join(timeout=30)
        assert not rx.is_alive()
    finally:
        if rx.is_alive():
            rx.join(timeout=5)
        if rb.exists(key):
            rb.destroy(key)

    assert len(blocks) >= 6
    lost = 0
    for bi in (4, 5):            # memory recycled from blocks bi-2 and bi-4
        arr = blocks[bi].view("<i2").reshape(NDF, NCHK, C.DT_SIZE // 2)
        for t in range(NDF):
            for c in range(NCHK):
                k = idf0 + bi * NDF + t
                if arr[t, c, 1] == 0:       # real payloads never have 0 here
                    lost += 1
                    assert not arr[t, c].any(), (
                        f"stale bytes at block {bi} frame {t} chunk {c}")
                else:
                    np.testing.assert_array_equal(
                        arr[t, c], expected_payload(k, c),
                        err_msg=f"block {bi} frame {t} chunk {c}")
    assert lost > 0              # 25% drop over 512 slots: ~128 expected


def test_capture_device_layout(ring_key):
    """device_layout=True: the host SIMD corner turn places every frame as
    14 per-series 512 B segments — the captured block equals the TFTFP
    block transposed to the (nseries, ndf, 256-lane) row form, so
    fine-channel steps consume it with no device corner turn."""
    port_base = _free_ports()
    eng, rc, idf0 = run_capture(ring_key, nframes=NDF,
                                port_base=port_base, device_layout=True)
    assert rc == 0
    blocks = read_blocks(ring_key)
    assert len(blocks) >= 1
    got = blocks[0].view("<i2")

    # expected wire block -> numpy corner turn (the _rows_i16 layout)
    wire = np.zeros((NDF, NCHK, 128, 7, 2, 2), np.int16)
    for rel in range(NDF):
        for ichk in range(NCHK):
            wire[rel, ichk] = expected_payload(idf0 + rel, ichk).reshape(
                128, 7, 2, 2)
    rows = wire.transpose(1, 3, 4, 0, 2, 5).reshape(NCHK * 14, NDF, 256)
    np.testing.assert_array_equal(got, rows.reshape(-1))
