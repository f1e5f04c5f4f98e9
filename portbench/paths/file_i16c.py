"""The streaming receiver fed from an interleaved int16 capture file through
FileStreamer and DeviceFeed."""

from __future__ import annotations

import os
import pathlib
import tempfile

import numpy as np
import torch

from portbench.paths.rx_stream import RxStream
from tpu_ofdm_torch.config import StreamConfig
from tpu_ofdm_torch.io import DeviceFeed
from tpu_ofdm_torch.modem.rx_stream import rx_stream_block
from tpu_ofdm_torch.runtime import FileStreamer
from tpu_ofdm_torch.stream.executor import StreamExecutor


class LoopingCapture:
    """A capture file as DeviceFeed's planar source, read again from its
    start at its end; keeps every block's (read, convert) seconds."""

    def __init__(self, open_streamer):
        self.open = open_streamer
        self.fs = open_streamer()
        self.block = self.fs.block
        self.times: list[tuple[float, float]] = []

    def read_into(self, re, im) -> int:
        n = self.fs.read_into(re, im)
        if n == 0:
            self.fs.close()
            self.fs = self.open()
            n = self.fs.read_into(re, im)
        self.times.append(self.fs.last_times)
        return n

    def close(self):
        self.fs.close()


class FileI16c(RxStream):
    """The streaming receiver fed from an interleaved int16 capture file:
    FileStreamer (its reader thread and the i16c converter) into
    DeviceFeed, replayed from the file's start at its end."""

    def setup(self):
        blocks = self.make_blocks()
        peak = float(torch.view_as_real(blocks).abs().max())
        self.scale = np.float32(peak / 32767)
        self.dir = tempfile.mkdtemp(prefix="portbench-")
        self.path = os.path.join(self.dir, "capture.i16c")
        with open(self.path, "wb") as fh:
            for b in range(self.n_blocks):
                iq = torch.view_as_real(blocks[b]) * (32767 / peak)
                iq.round_().clamp_(-32768, 32767)
                iq.to(torch.int16).cpu().numpy().tofile(fh)
        del blocks
        self.raw = np.memmap(self.path, dtype=np.int16, mode="r")
        item = 4
        self.source = LoopingCapture(lambda: FileStreamer(
            self.path, "i16c", block_size=self.S,
            ring_bytes=self.mix["ring_blocks"] * self.S * item,
            scale=float(self.scale)))
        self.feed = DeviceFeed(self.source, depth=self.mix["feed_depth"],
                               device=self.dev)
        self.it = iter(self.feed)
        self.ex = StreamExecutor(
            rx_stream_block(self.pspec, StreamConfig(self.S, self.K)),
            self.S, device=self.dev)

    def close(self):
        feed = getattr(self, "feed", None)
        if feed is not None:
            feed.close()
            self.source.close()
        if getattr(self, "dir", None):
            del self.raw
            pathlib.Path(self.path).unlink(missing_ok=True)
            os.rmdir(self.dir)
            self.dir = None

    def push(self, step):
        with self.spans("feed"):
            x = next(self.it)
        with self.spans("push"):
            return self.ex.push(x)

    def block_samples(self, b, lo, hi):
        iq = self.raw[2 * (b * self.S + lo): 2 * (b * self.S + hi)]
        iq = iq.astype(np.float64) * float(self.scale)
        return iq[0::2] + 1j * iq[1::2]


Path = FileI16c
