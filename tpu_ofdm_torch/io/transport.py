"""UDP transport for the distributed spectrum analyzer (a numpy-only copy
of tpu_ofdm/io/transport.py, byte for byte the same wire format, so a JAX
worker reaches a port client and the reverse).

Host-side wire protocol replacing gr-ofdm_tools' local_worker <->
remote_client socket pair (python/local_worker.py + remote_client.py).
The worker ships packed PSD summaries (avg + max-hold vectors with
center-freq/rate metadata) as datagrams; the client renders them and sends
control messages (retune, gain) back.

This is deliberately a HOST-side concern: it serves the reference's
actual deployment shape -- an analyzer UI on a different machine from the
capture frontend.

Wire format (little-endian), one datagram per update:
  magic  u32   0x54505346 ("TPSF")
  seq    u32
  time   f64   unix seconds
  cfreq  f64   center frequency, Hz
  rate   f64   sample rate, Hz
  nfft   u32
  nfr    u32   frames accumulated
  avg    f32[nfft]  dB
  max    f32[nfft]  dB
Control datagrams are single JSON objects (cf. the reference's PMT control
messages), e.g. {"cmd": "retune", "freq": 2.4e9} or {"cmd": "gain", ...}.
"""

from __future__ import annotations

import json
import socket
import struct
import time
from dataclasses import dataclass

import numpy as np

MAGIC = 0x54505346
_HDR = struct.Struct("<IIdddII")


@dataclass
class SpectrumFrame:
    seq: int
    timestamp: float
    center_freq: float
    sample_rate: float
    avg_db: np.ndarray
    max_db: np.ndarray
    n_frames: int


def pack_spectrum(
    seq: int,
    center_freq: float,
    sample_rate: float,
    avg_db: np.ndarray,
    max_db: np.ndarray,
    n_frames: int,
    timestamp: float | None = None,
) -> bytes:
    avg = np.ascontiguousarray(avg_db, dtype=np.float32)
    mx = np.ascontiguousarray(max_db, dtype=np.float32)
    if avg.shape != mx.shape or avg.ndim != 1:
        raise ValueError(f"avg and max must be 1-D of one length, got "
                         f"{avg.shape} and {mx.shape}")
    hdr = _HDR.pack(
        MAGIC, seq & 0xFFFFFFFF,
        time.time() if timestamp is None else timestamp,
        center_freq, sample_rate, len(avg), n_frames,
    )
    return hdr + avg.tobytes() + mx.tobytes()


def unpack_spectrum(data: bytes) -> SpectrumFrame:
    magic, seq, ts, cfreq, rate, nfft, nfr = _HDR.unpack_from(data)
    if magic != MAGIC:
        raise ValueError(f"bad magic {magic:#x}")
    off = _HDR.size
    avg = np.frombuffer(data, np.float32, nfft, off)
    mx = np.frombuffer(data, np.float32, nfft, off + 4 * nfft)
    return SpectrumFrame(seq, ts, cfreq, rate, avg.copy(), mx.copy(), nfr)


class SpectrumPublisher:
    """Worker side: sends spectrum frames, polls for control messages."""

    def __init__(self, remote_addr: tuple[str, int], bind_port: int = 0):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(("0.0.0.0", bind_port))
        self.sock.setblocking(False)
        self.remote = remote_addr
        self.seq = 0

    @property
    def port(self) -> int:
        return self.sock.getsockname()[1]

    def publish(self, center_freq, sample_rate, avg_db, max_db, n_frames):
        pkt = pack_spectrum(
            self.seq, center_freq, sample_rate, avg_db, max_db, n_frames
        )
        self.sock.sendto(pkt, self.remote)
        self.seq += 1

    def poll_control(self) -> list[dict]:
        """Drain pending control messages (non-blocking)."""
        msgs = []
        while True:
            try:
                data, _ = self.sock.recvfrom(65536)
            except BlockingIOError:
                return msgs
            try:
                msgs.append(json.loads(data.decode()))
            except (UnicodeDecodeError, json.JSONDecodeError):
                continue  # drop malformed control packets (UDP semantics)

    def close(self):
        self.sock.close()


class SpectrumSubscriber:
    """Client side: receives spectrum frames, sends control back."""

    def __init__(self, bind_port: int, worker_addr: tuple[str, int] | None = None):
        self.sock = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
        self.sock.bind(("0.0.0.0", bind_port))
        self.worker = worker_addr
        self._last_peer = None

    @property
    def port(self) -> int:
        return self.sock.getsockname()[1]

    def receive(self, timeout: float | None = 1.0) -> SpectrumFrame | None:
        self.sock.settimeout(timeout)
        try:
            data, peer = self.sock.recvfrom(1 << 20)
        except (socket.timeout, BlockingIOError):
            return None
        self._last_peer = peer
        return unpack_spectrum(data)

    def send_control(self, msg: dict):
        target = self.worker or self._last_peer
        if target is None:
            raise RuntimeError("no worker address known yet")
        self.sock.sendto(json.dumps(msg).encode(), target)

    def close(self):
        self.sock.close()
