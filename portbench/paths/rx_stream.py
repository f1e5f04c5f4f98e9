"""The streaming receiver (rx_stream_block) over staged blocks of golden
frames in noise."""

from __future__ import annotations

import numpy as np
import torch

from portbench import traffic as T
from portbench.reference import receiver as R
from tpu_ofdm_torch.config import OfdmConfig, StreamConfig
from tpu_ofdm_torch.modem.rx_stream import (collect_frames, history_len,
                                            rx_stream_block)
from tpu_ofdm_torch.stream.executor import StreamExecutor


class RxStream:
    """The streaming receiver (rx_stream_block) over staged blocks."""

    span = 48            # the reference's search either side of a frame

    def __init__(self, cfg: dict, mix: dict, seed: int, device, spans):
        self.cfg, self.mix, self.seed = cfg, mix, seed
        self.dev = torch.device(device)
        self.spans = spans
        self.pspec = OfdmConfig(**cfg["ofdm"]).spec
        self.ref = R.Spec(**cfg["ofdm"])
        self.S = cfg["stream"]["block_size"]
        self.K = cfg["stream"]["max_frames_per_block"]
        self.H = history_len(self.pspec)
        self.n_blocks = mix["blocks"]

    # -- set-up ------------------------------------------------------------
    def make_blocks(self):
        s_frames, s_noise = T.seeds(self.seed, 2)
        rng = np.random.default_rng(s_frames)
        self.frames = T.dense_frames(self.ref, rng, self.n_blocks, self.S,
                                     self.mix)
        blocks = T.noise_blocks(self.n_blocks, self.S, self.mix["noise_rms"],
                                s_noise, self.dev)
        T.add_segments(blocks, [(b, f.pos, f.samples)
                                for b, row in enumerate(self.frames)
                                for f in row])
        return blocks

    def setup(self):
        self.blocks = self.make_blocks()
        self.ex = StreamExecutor(
            rx_stream_block(self.pspec, StreamConfig(self.S, self.K)),
            self.S, device=self.dev)

    def close(self):
        pass

    # -- the window --------------------------------------------------------
    def push(self, step: int):
        x = self.blocks[step % self.n_blocks]
        with self.spans("push"):
            return self.ex.push(x)

    def collect(self, out) -> list[dict]:
        with self.spans("collect"):
            return collect_frames([out], block_size=self.S, hist=self.H)

    def for_check(self, out, frames: list[dict]) -> list[dict]:
        """collect_frames already gives every field the check compares."""
        del out
        return frames

    @property
    def samples_per_push(self) -> int:
        return self.S

    def work(self) -> dict:
        """The shapes the layers' rooflines count work from."""
        return {"detect": {"buffers": 1, "samples": self.H + self.S,
                           "slots": self.K}}

    # -- the check -----------------------------------------------------------
    def expected(self, step: int) -> list[tuple[int, int, T.Frame]]:
        """(channel, absolute position, frame) of each frame that push
        `step` must report."""
        return [(f.channel, step * self.S + f.pos, f)
                for f in self.frames[step % self.n_blocks]]

    def t_origin(self, step: int) -> int:
        """The absolute sample at which push `step`'s virtual buffer
        [history | block] starts."""
        return step * self.S - self.H

    def block_samples(self, b: int, lo: int, hi: int) -> np.ndarray:
        return self.blocks[b, lo:hi].cpu().numpy().astype(np.complex128)

    def stream(self, channel: int, lo: int, hi: int, q=R.exact):
        """Input samples [lo, hi) of the stream (zeros before it starts)."""
        del channel
        parts = []
        while lo < hi:
            s, off = divmod(lo, self.S)
            end = min(hi, (s + 1) * self.S)
            if s < 0:
                parts.append(np.zeros(end - lo, np.complex128))
            else:
                parts.append(self.block_samples(s % self.n_blocks, off,
                                                off + end - lo))
            lo = end
        return q(np.concatenate(parts))


Path = RxStream
