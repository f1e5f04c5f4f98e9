"""The wideband receiver (wideband_rx_block) over staged wideband blocks
whose frames go through one synthesis filterbank a block: the traffic of
a band with most channels occupied."""

from __future__ import annotations

import numpy as np

from portbench import traffic as T
from portbench.paths.wideband import Wideband


def synthesize(row, n_chan: int, taps: np.ndarray):
    """(start, samples) of the bursts of every frame in `row` that starts
    at one per-channel position, as one signal: the sum of
    traffic.burst over those frames, each scaled by n_chan as
    traffic.wideband_segments scales it.  traffic.burst convolves each
    upsampled frame with the whole prototype (len(frame) * n_chan *
    len(taps) operations a frame); here the frames' channel sums are one
    inverse DFT across the channels a channel sample, and each of its
    n_chan phases is filtered by the prototype's J taps on that phase, the
    synthesis filterbank's polyphase form."""
    pos = {f.pos for f in row}
    if len(pos) != 1:
        raise ValueError("the frames of a row start at one position")
    J = -(-len(taps) // n_chan)
    hp = np.zeros(J * n_chan)
    hp[:len(taps)] = taps
    hp = hp.reshape(J, n_chan)                  # hp[j, p] = taps[j N + p]
    F = max(len(f.samples) for f in row)
    g = np.zeros((F, n_chan), np.complex128)    # g[m, k]: channel k's sample m
    for f in row:
        g[:len(f.samples), f.channel] += f.samples * n_chan
    u = np.fft.ifft(g, axis=1) * n_chan         # u[m, p] = sum_k g e^{2pi i kp/N}
    out = np.zeros((F + J, n_chan), np.complex128)
    for j in range(J):
        out[j:j + F] += u * hp[j]
    n = F * n_chan + len(taps) - 1              # traffic.burst's length
    return pos.pop() * n_chan, out.reshape(-1)[:n]


class WidebandBank(Wideband):
    """Wideband's traffic (traffic.wideband_frames on mix["channels"],
    noise, the receiver and the check as Wideband's), with each block's
    bursts made by synthesize: the same signal for ~3e7 operations a block
    where traffic.burst takes ~1.5e9 a frame at 512 channels."""

    def make_blocks(self):
        s_frames, s_noise = T.seeds(self.seed, 2)
        rng = np.random.default_rng(s_frames)
        self.frames = T.wideband_frames(self.ref, rng, self.n_blocks,
                                        self.mix)
        blocks = T.noise_blocks(self.n_blocks, self.S, self.mix["noise_rms"],
                                s_noise, self.dev)
        T.add_segments(blocks, [(b, *synthesize(row, self.n_chan, self.taps))
                                for b, row in enumerate(self.frames)])
        return blocks


Path = WidebandBank
