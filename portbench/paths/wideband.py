"""The wideband receiver (wideband_rx_block): the polyphase channelizer
feeding parallel demods, over staged wideband blocks."""

from __future__ import annotations

import numpy as np

from portbench import traffic as T
from portbench.paths.rx_stream import RxStream
from portbench.reference import golden_ofdm as G
from portbench.reference import receiver as R
from tpu_ofdm_torch.config import StreamConfig
from tpu_ofdm_torch.modem.wideband import (collect_wideband_frames,
                                           wideband_rx_block)
from tpu_ofdm_torch.stream.executor import StreamExecutor


class Wideband(RxStream):
    """The wideband receiver (wideband_rx_block): the channelizer and the
    parallel demods, over staged wideband blocks."""

    span = 64            # the filterbanks' delay lies inside it

    def __init__(self, cfg, mix, seed, device, spans):
        super().__init__(cfg, mix, seed, device, spans)
        self.n_chan = cfg["n_chan"]
        self.Sc = self.S // self.n_chan
        self.J = cfg["taps_per_arm"]
        self.taps = G.lowpass_taps(self.n_chan, self.J)

    def make_blocks(self):
        s_frames, s_noise = T.seeds(self.seed, 2)
        rng = np.random.default_rng(s_frames)
        self.frames = T.wideband_frames(self.ref, rng, self.n_blocks,
                                        self.mix)
        blocks = T.noise_blocks(self.n_blocks, self.S, self.mix["noise_rms"],
                                s_noise, self.dev)
        T.add_segments(blocks, T.wideband_segments(self.frames, self.n_chan,
                                                   self.taps))
        return blocks

    def setup(self):
        self.blocks = self.make_blocks()
        self.ex = StreamExecutor(wideband_rx_block(
            self.pspec, self.n_chan, StreamConfig(self.S, self.K),
            taps=self.taps),
            self.S, device=self.dev)

    def collect(self, out):
        with self.spans("collect"):
            return collect_wideband_frames([out], self.Sc, self.pspec)

    def for_check(self, out, frames):
        """The collected frames with the fields collect_wideband_frames
        leaves out, hdr_ok and fine CFO, read from the output by (channel,
        slot): the sink lists the valid slots in the same order."""
        res = out.result
        slots = np.nonzero(res.valid.cpu().numpy())
        if len(slots[0]) != len(frames):
            raise AssertionError("the sink's frames are not the valid slots")
        hdr = res.frames.hdr_ok.cpu().numpy()[slots]
        cfo = res.fine_cfo.cpu().numpy()[slots]
        return [{**f, "hdr_ok": bool(h), "fine_cfo": float(c)}
                for f, h, c in zip(frames, hdr, cfo)]

    def work(self):
        return {"detect": {"buffers": self.n_chan, "samples": self.H + self.Sc,
                           "slots": self.K},
                "pfb": {"samples": self.S, "channels": self.n_chan,
                        "taps_per_arm": self.J}}

    def expected(self, step):
        return [(f.channel, step * self.Sc + f.pos, f)
                for f in self.frames[step % self.n_blocks]]

    def t_origin(self, step):
        return step * self.Sc - self.H

    def stream(self, channel, lo, hi, q=R.exact):
        """Channel `channel`'s samples [lo, hi), channelized by the
        reference from the wideband input."""
        N = self.n_chan
        wide = RxStream.stream(self, 0, (lo - self.J + 1) * N, hi * N, q)
        return R.channelize_rows(wide, N, self.taps, q)[:, channel]


Path = Wideband
