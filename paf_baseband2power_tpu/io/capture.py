"""Python binding for the native UDP capture engine.

Wraps ``native/capture.cpp`` (see its header for the behavioral contract —
the re-design of the reference's pthread capture stack). The
binding drives the probe/start/wait lifecycle, surfaces stream-start info
for DADA header registration, and exposes per-port packet statistics (the
``statistics()`` report of ``capture.c:700-725``).
"""

from __future__ import annotations

import ctypes
import dataclasses

from .. import constants as C
from .ringbuffer import load_library


class _ConfStruct(ctypes.Structure):
    _fields_ = [
        ("ip", ctypes.c_char * 64),
        ("port_base", ctypes.c_int),
        ("nports", ctypes.c_int),
        ("ring_key", ctypes.c_char * 64),
        ("ndf_blk", ctypes.c_uint64),
        ("nchk", ctypes.c_uint32),
        ("freq_base", ctypes.c_double),
        ("chunk_bw", ctypes.c_double),
        ("tbuf_ndf", ctypes.c_uint32),
        ("timeout_sec", ctypes.c_double),
        ("ndf_check", ctypes.c_uint64),
        ("length_sec", ctypes.c_double),
        ("cpu_base", ctypes.c_int),
        ("zero_blocks", ctypes.c_int),
        ("beam", ctypes.c_int),
        ("numa_node", ctypes.c_int),
        ("device_layout", ctypes.c_int),
    ]


def _bind(lib):
    if getattr(lib, "_capture_bound", False):
        return lib
    i32, u32, u64 = ctypes.c_int, ctypes.c_uint32, ctypes.c_uint64
    vp = ctypes.c_void_p
    sigs = {
        "pafb2p_capture_create": (vp, [ctypes.POINTER(_ConfStruct)]),
        "pafb2p_capture_destroy": (None, [vp]),
        "pafb2p_capture_probe": (i32, [vp]),
        "pafb2p_capture_start": (i32, [vp]),
        "pafb2p_capture_wait": (i32, [vp]),
        "pafb2p_capture_stop": (None, [vp]),
        "pafb2p_capture_ref_sec": (u64, [vp]),
        "pafb2p_capture_ref_idf": (u64, [vp]),
        "pafb2p_capture_epoch": (u32, [vp]),
        "pafb2p_capture_freq_center": (ctypes.c_double, [vp]),
        "pafb2p_capture_active_ports": (i32, [vp]),
        "pafb2p_capture_active_chunks": (i32, [vp]),
        "pafb2p_capture_frames_received": (u64, [vp, i32]),
        "pafb2p_capture_frames_expected": (u64, [vp, i32]),
        "pafb2p_capture_frames_dropped": (u64, [vp, i32]),
        "pafb2p_capture_frames_invalid": (u64, [vp, i32]),
        "pafb2p_capture_port_elapsed": (ctypes.c_double, [vp, i32]),
        "pafb2p_capture_blocks_committed": (u64, [vp]),
        "pafb2p_capture_force_switches": (u64, [vp]),
    }
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    lib._capture_bound = True
    return lib


@dataclasses.dataclass
class CaptureConf:
    ip: str = "0.0.0.0"
    port_base: int = C.PORT_BASE
    nports: int = C.NPORT_NIC
    ring_key: str = C.DEFAULT_KEY_IN
    ndf_blk: int = C.NDF_BLK
    nchk: int = C.NCHK_NIC
    freq_base: float = 1000.0
    chunk_bw: float = 7.0
    tbuf_ndf: int = C.TBUF_NDF
    timeout_sec: float = float(C.PRD_SEC)
    ndf_check: int = C.NDF_CHECK
    length_sec: float = 0.0
    cpu_base: int = -1
    zero_blocks: bool = True
    beam: int = -1   # accept only this beam id; -1 = any
    numa_node: int = -1  # NUMA-aware pinning: thread i -> node*10 + i
                         # (the reference's placement, sync.c:48-59)
    device_layout: bool = False  # corner-turn frames during placement
                                 # into the series-row layout (SIMD on
                                 # the host) so fine-channel steps skip
                                 # the device corner turn

    def to_struct(self) -> _ConfStruct:
        s = _ConfStruct()
        s.ip = self.ip.encode()
        s.port_base = self.port_base
        s.nports = self.nports
        s.ring_key = self.ring_key.encode()
        s.ndf_blk = self.ndf_blk
        s.nchk = self.nchk
        s.freq_base = self.freq_base
        s.chunk_bw = self.chunk_bw
        s.tbuf_ndf = self.tbuf_ndf
        s.timeout_sec = self.timeout_sec
        s.ndf_check = self.ndf_check
        s.length_sec = self.length_sec
        s.cpu_base = self.cpu_base
        s.zero_blocks = int(self.zero_blocks)
        s.beam = self.beam
        s.numa_node = self.numa_node
        s.device_layout = int(self.device_layout)
        return s


@dataclasses.dataclass
class PortStats:
    port: int
    received: int
    expected: int
    dropped: int
    invalid: int = 0      # frames rejected for a cleared valid bit
    elapsed: float = 0.0  # seconds between first and last accepted frame
                          # (per-socket elapsed_time, capture.c:450,552)

    @property
    def loss_rate(self) -> float:
        if self.expected == 0:
            return 0.0
        lost = max(0, self.expected - self.received)
        return lost / self.expected


class CaptureError(OSError):
    pass


class CaptureEngine:
    """probe -> start -> (stats/stop) -> wait lifecycle wrapper."""

    def __init__(self, conf: CaptureConf):
        self.conf = conf
        self._lib = _bind(load_library())
        self._struct = conf.to_struct()
        self._h = self._lib.pafb2p_capture_create(ctypes.byref(self._struct))
        if not self._h:
            raise CaptureError(22, "invalid capture configuration")

    def probe(self) -> int:
        rc = self._lib.pafb2p_capture_probe(self._h)
        if rc < 0:
            raise CaptureError(-rc, f"probe failed (errno {-rc})")
        return rc

    def start(self) -> None:
        rc = self._lib.pafb2p_capture_start(self._h)
        if rc < 0:
            raise CaptureError(-rc, f"capture start failed: errno {-rc}")

    def wait(self) -> int:
        """Join capture; returns 0 on clean finish, 1 if the engine quit
        because a port fell irrecoverably behind."""
        return self._lib.pafb2p_capture_wait(self._h)

    def stop(self) -> None:
        self._lib.pafb2p_capture_stop(self._h)

    # stream-start info (for DADA header registration) ----------------------
    @property
    def ref_sec(self) -> int:
        return self._lib.pafb2p_capture_ref_sec(self._h)

    @property
    def ref_idf(self) -> int:
        return self._lib.pafb2p_capture_ref_idf(self._h)

    @property
    def epoch(self) -> int:
        return self._lib.pafb2p_capture_epoch(self._h)

    @property
    def freq_center(self) -> float:
        return self._lib.pafb2p_capture_freq_center(self._h)

    @property
    def active_ports(self) -> int:
        return self._lib.pafb2p_capture_active_ports(self._h)

    @property
    def active_chunks(self) -> int:
        return self._lib.pafb2p_capture_active_chunks(self._h)

    # statistics ------------------------------------------------------------
    def port_stats(self) -> list[PortStats]:
        out = []
        for p in range(self.conf.nports):
            out.append(PortStats(
                port=self.conf.port_base + p,
                received=self._lib.pafb2p_capture_frames_received(self._h, p),
                expected=self._lib.pafb2p_capture_frames_expected(self._h, p),
                dropped=self._lib.pafb2p_capture_frames_dropped(self._h, p),
                invalid=self._lib.pafb2p_capture_frames_invalid(self._h, p),
                elapsed=self._lib.pafb2p_capture_port_elapsed(self._h, p),
            ))
        return out

    @property
    def blocks_committed(self) -> int:
        return self._lib.pafb2p_capture_blocks_committed(self._h)

    @property
    def force_switches(self) -> int:
        return self._lib.pafb2p_capture_force_switches(self._h)

    def close(self) -> None:
        if self._h:
            self._lib.pafb2p_capture_destroy(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
