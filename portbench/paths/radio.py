"""The full-duplex radio (ofdm_radio), its TX half's output carried to its
RX half one push later through the benchmark's own air hop."""

from __future__ import annotations

import numpy as np
import torch

from portbench import traffic as T
from portbench.paths.rx_stream import RxStream
from portbench.reference import receiver as R
from tpu_ofdm_torch.config import StreamConfig
from tpu_ofdm_torch.modem.radio import ofdm_radio
from tpu_ofdm_torch.modem.rx_stream import collect_frames
from tpu_ofdm_torch.modem.tx_stream import TxStreamIn
from tpu_ofdm_torch.stream.executor import StreamExecutor


class Radio(RxStream):
    """The full-duplex radio (ofdm_radio): each push queues a batch of
    PDUs on the TX half and takes the air block on the RX half; the TX
    block of push i reaches the RX half of push i + 1 through the
    benchmark's own air hop (a CFO, then AWGN)."""

    def __init__(self, cfg, mix, seed, device, spans):
        super().__init__(cfg, mix, seed, device, spans)
        self.gap = 4 * self.ref.cp_len        # the TX half's default gap
        self.cfo = mix["cfo"]
        self.noise_rms = float(np.sqrt(10 ** (-mix["snr_db"] / 10) / 2))

    def setup(self):
        s_frames, s_noise = T.seeds(self.seed, 2)
        rng = np.random.default_rng(s_frames)
        n, K = self.mix["pdus_per_push"], self.K
        cap = self.ref.max_payload_bytes - 4
        pays, nums = T.payloads(rng, n * self.n_blocks,
                                *self.mix["payload_bytes"])
        self.pdus, self.inputs = [], []
        for b in range(self.n_blocks):
            pb, nb = pays[b * n:(b + 1) * n], nums[b * n:(b + 1) * n]
            self.pdus.append(list(zip(pb, nb)))
            pay = np.zeros((K, cap), np.uint8)
            ln = np.zeros(K, np.int32)
            fn = np.zeros(K, np.int32)
            for k, (p, m) in enumerate(zip(pb, nb)):
                pay[k, :len(p)] = np.frombuffer(p, np.uint8)
                ln[k], fn[k] = len(p), m
            self.inputs.append(TxStreamIn(*(torch.as_tensor(a, device=self.dev)
                                            for a in (pay, ln, fn,
                                                      np.arange(K) < n))))
        self.frames = [None] * self.n_blocks    # the TX frames, made lazily
        self.noise = T.noise_blocks(self.n_blocks, self.S, self.noise_rms,
                                    s_noise, self.dev)
        n_ = torch.arange(self.S, device=self.dev, dtype=torch.float64)
        ph = (2 * np.pi * self.cfo / self.ref.fft_len) * n_
        self.rot = torch.polar(torch.ones_like(ph), ph).to(torch.complex64)
        del n_, ph
        self.air = torch.zeros(self.S, dtype=torch.complex64, device=self.dev)
        self.ex = StreamExecutor(
            ofdm_radio(self.pspec, StreamConfig(self.S, self.K)), self.S,
            device=self.dev)

    def phase(self, step: int) -> complex:
        """The CFO's phase at the first sample of block `step`, exact."""
        cyc = (self.cfo * self.S * step / self.ref.fft_len) % 1.0
        return complex(np.exp(2j * np.pi * cyc))

    def push(self, step):
        with self.spans("push"):
            out = self.ex.push((self.inputs[step % self.n_blocks], self.air))
        with self.spans("air"):
            self.air = (out.tx.samples * self.rot * self.phase(step + 1)
                        + self.noise[(step + 1) % self.n_blocks])
        return out

    def collect(self, out):
        with self.spans("collect"):
            return collect_frames([out.rx], block_size=self.S, hist=self.H)

    def tx_frames(self, b: int) -> list[T.Frame]:
        """The frames that a push of batch b transmits, placed as the TX
        half places them: one after the other from the block's start,
        each followed by `gap` samples of silence."""
        if self.frames[b] is None:
            pos, row = 0, []
            for p, m in self.pdus[b]:
                s = T.golden(self.ref, p, m)
                row.append(T.Frame(0, pos, p, m, s))
                pos += len(s) + self.gap
            if pos > self.S:
                raise ValueError("a batch's frames overflow the block")
            self.frames[b] = row
        return self.frames[b]

    def expected(self, step):
        if step == 0:
            return []
        return [(0, step * self.S + f.pos, f)
                for f in self.tx_frames((step - 1) % self.n_blocks)]

    def stream(self, channel, lo, hi, q=R.exact):
        """The air samples [lo, hi): the reference's TX of the push before,
        the CFO from the stream's start, and the hop's noise."""
        out = []
        while lo < hi:
            s, off = divmod(lo, self.S)
            end = min(hi, (s + 1) * self.S)
            seg = np.zeros(end - lo, np.complex128)
            if s > 0:
                for f in self.tx_frames((s - 1) % self.n_blocks):
                    a, z = max(f.pos, off), min(f.pos + len(f.samples),
                                                off + end - lo)
                    if a < z:
                        seg[a - off: z - off] = f.samples[a - f.pos: z - f.pos]
                n = s * self.S + np.arange(off, off + end - lo)
                seg *= np.exp(2j * np.pi * ((self.cfo * n / self.ref.fft_len)
                                            % 1.0))
            if s > 0:          # the first push's air block is silent
                seg += self.noise[s % self.n_blocks, off:off + end - lo] \
                    .cpu().numpy()
            out.append(seg)
            lo = end
        return q(np.concatenate(out))

    def tx_block(self, step: int) -> np.ndarray:
        """The reference's TX output of push `step` up to its last frame's
        end (zeros after it)."""
        row = self.tx_frames(step % self.n_blocks)
        want = np.zeros(row[-1].pos + len(row[-1].samples), np.complex128)
        for f in row:
            want[f.pos: f.pos + len(f.samples)] = f.samples
        return want

    def tx_gap(self, out, step: int) -> float:
        """The widest gap between the TX half's output of push `step` and
        the reference's, over the whole block."""
        want = self.tx_block(step)
        got = out.tx.samples
        head = got[:len(want)].cpu().numpy() - want
        tail = (float(got[len(want):].abs().max()) if len(want) < self.S
                else 0.0)
        return max(float(np.abs(head).max()), tail)

    def tx_wrong(self, out) -> int:
        """Slots the TX half accepted that held no PDU, or refused."""
        acc = out.tx.accepted.cpu().numpy()
        n = self.mix["pdus_per_push"]
        return int((~acc[:n]).sum() + acc[n:].sum())


Path = Radio
