"""The streaming receiver (rx_stream_block) over staged blocks of golden
frames in noise, each frame with a carrier frequency offset of its own."""

from __future__ import annotations

import dataclasses

import numpy as np

from portbench import traffic as T
from portbench.paths.rx_stream import RxStream
from portbench.reference import golden_ofdm as G


class RxCfo(RxStream):
    """RxStream's traffic with each frame moved by its own CFO, drawn from
    the seed uniformly over mix["cfo_subcarriers"] (in subcarrier
    spacings), from a uniform start phase: the reference's channel model
    applied to the golden samples in float64 before they join their block.
    The receiver and the check read the staged blocks, as RxStream's do."""

    def make_blocks(self):
        s_frames, s_noise, s_cfo = T.seeds(self.seed, 3)
        rng = np.random.default_rng(s_frames)
        frames = T.dense_frames(self.ref, rng, self.n_blocks, self.S,
                                self.mix)
        crng = np.random.default_rng(s_cfo)
        n = self.n_blocks * self.mix["frames_per_block"]
        cfo = crng.uniform(*self.mix["cfo_subcarriers"], n)
        phase = crng.uniform(0.0, 2 * np.pi, n)
        self.frames, self.cfo = [], []
        for b, row in enumerate(frames):
            k = b * len(row) + np.arange(len(row))
            self.cfo.append([float(c) for c in cfo[k]])
            self.frames.append([dataclasses.replace(f, samples=G.channel(
                f.samples, cfo=c, fft_len=self.ref.fft_len, phase=p))
                for f, c, p in zip(row, cfo[k], phase[k])])
        blocks = T.noise_blocks(self.n_blocks, self.S, self.mix["noise_rms"],
                                s_noise, self.dev)
        T.add_segments(blocks, [(b, f.pos, f.samples)
                                for b, row in enumerate(self.frames)
                                for f in row])
        return blocks


Path = RxCfo
