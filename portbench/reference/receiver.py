"""The plain reference of the receivers' answers, in float64 numpy.

It states what one detected frame must come out as: the streaming
receivers' detection rule (the Schmidl-Cox metric normalised by both
half-window energies, a boxcar of cp + 1 over it, its argmax with the
deterministic tie-break ramp, the start cp - backoff past the argmax, the
fine CFO from P at the plateau's centre) and the golden chain's
demodulation (derotation, per-symbol FFT, integer CFO, LS estimate,
pilot-phase equalisation, header, payload, CRC32, EVM).  The golden
chain's own detector (a plateau search) is not the streaming rule, so the
metric is written out here; everything after the start comes from
`golden_ofdm`.  It imports nothing of the program.

Every stage takes a rounding function `q`: `exact` for the reference, and
`bf16` for the control, which computes each stage's output in bfloat16.
"""

from __future__ import annotations

import numpy as np

from portbench.reference import golden_ofdm as G

TIE_RAMP = 1e-7          # the detector's tie-break: (t & 0xFFFF) * 1e-7


def exact(x):
    return x


def _bf16_real(x: np.ndarray) -> np.ndarray:
    """Round float values to bfloat16 (nearest, ties to even)."""
    u = np.asarray(x, dtype=np.float32).view(np.uint32).astype(np.uint64)
    u = (u + 0x7FFF + ((u >> 16) & 1)) & 0xFFFF0000
    return u.astype(np.uint32).view(np.float32).astype(np.float64)


def bf16(x):
    """x with each real part and imaginary part rounded to bfloat16."""
    x = np.asarray(x)
    if np.iscomplexobj(x):
        return _bf16_real(x.real) + 1j * _bf16_real(x.imag)
    return _bf16_real(x)


class Spec:
    """A configuration's OFDM parameters, as the reference needs them."""

    def __init__(self, fft_len: int, cp_len: int, modulation: str,
                 max_payload_bytes: int, **_):
        self.p = G.GoldenOfdmParams(fft_len=fft_len, cp_len=cp_len,
                                    modulation=modulation)
        self.fft_len, self.cp_len = fft_len, cp_len
        self.sym_len = fft_len + cp_len
        self.L = fft_len // 2
        self.backoff = min(4, cp_len // 4)
        self.max_payload_bytes = max_payload_bytes
        self.max_frame_len = (3 + G.payload_num_symbols(
            self.p, max_payload_bytes)) * self.sym_len


def window_sums(x: np.ndarray, w: int) -> np.ndarray:
    """Valid-mode sums of w consecutive terms: out[d] = x[d:d + w].sum()."""
    c = np.concatenate([[0], np.cumsum(x)])
    return c[w:] - c[:-w]


def smoothed_metric(s: Spec, r: np.ndarray, q=exact):
    """The detector's smoothed metric over the samples r: (sm, P), where
    sm[j] is the mean of M over [j, j + cp] and P[d] = sum_{m<L}
    conj(r[d+m]) r[d+m+L]; M = |P|^2 / (R1 R2), capped at 2, with R1 and
    R2 the energies of the two half-windows."""
    L, W = s.L, s.cp_len + 1
    r = q(np.asarray(r, dtype=np.complex128))
    prod = q(np.conj(r[:-L]) * r[L:])
    e = q(np.abs(r) ** 2)
    P = q(window_sums(prod, L))
    r1 = q(window_sums(e[:-L], L))
    r2 = q(window_sums(e[L:], L))
    den = r1 * r2
    M = np.where(den > 0, np.minimum(np.abs(P) ** 2 / np.maximum(den, 1e-300),
                                     2.0), 0.0)
    M = q(M)
    return q(window_sums(M, W) / W), P


class Detection:
    """The metric around one frame: `smf` over the argmax positions
    lo .. lo + len(smf) - 1 (absolute), and P at the same region."""

    def __init__(self, s: Spec, r: np.ndarray, lo: int, t_origin: int, q):
        self.s, self.lo = s, lo
        sm, self.P = smoothed_metric(s, r, q)
        # the ramp's t is the trailing sample of a boxcar window, counted
        # in the receiver's virtual buffer, which starts at t_origin
        t = lo + np.arange(len(sm)) - t_origin + 2 * s.L + s.cp_len - 1
        self.ramp = (t & 0xFFFF) * TIE_RAMP
        self.smf = sm + self.ramp

    def best(self) -> int:
        """The absolute argmax position (the receiver picks the first)."""
        return self.lo + int(np.argmax(self.smf))

    def gap(self, j: int) -> float:
        """How far below the best the metric at position j lies, as a share
        of the best; 1 where j lies outside the region."""
        k = j - self.lo
        top = float(self.smf.max())
        if not 0 <= k < len(self.smf) or top <= 0:
            return 1.0
        return (top - float(self.smf[k])) / top

    def metric(self, j: int) -> float:
        """The smoothed metric at position j, without the tie-break ramp."""
        return float(self.smf[j - self.lo] - self.ramp[j - self.lo])

    def fine_cfo(self, j: int) -> float:
        """Fractional CFO in subcarriers from P at the plateau's centre of
        the boxcar that starts at j."""
        k = j - self.lo + self.s.cp_len - self.s.cp_len // 2
        return float(np.angle(self.P[k]) / np.pi)


def detect(s: Spec, stream, pos: int, span: int, t_origin: int, q=exact):
    """The metric over argmax positions pos - span .. pos + span of the
    absolute sample stream `stream(lo, hi)` (complex samples [lo, hi))."""
    lo = pos - span
    r = stream(lo, pos + span + s.cp_len + 2 * s.L)
    return Detection(s, r, lo, t_origin, q)


def start_of(s: Spec, j: int) -> int:
    """The frame start the receiver reports for argmax position j."""
    return j + s.cp_len - s.backoff


def argmax_of(s: Spec, start: int) -> int:
    return start - s.cp_len + s.backoff


def demod(s: Spec, win: np.ndarray, fine_cfo: float, q=exact) -> dict:
    """Demodulate the frame whose window `win` (max_frame_len samples)
    starts at the detected start: the golden chain's RX after detection.
    Returns payload (bytes, without the CRC), frame_num, hdr_ok, crc_ok and
    evm; hdr_ok False (and nothing else) where the header fails."""
    p, N = s.p, s.fft_len
    n = np.arange(len(win))
    win = q(np.asarray(win, np.complex128)
            * np.exp(-2j * np.pi * fine_cfo * n / N))

    def fft_sym(k):
        a = k * s.sym_len
        return q(np.fft.fft(win[a: a + N]) / np.sqrt(N))

    s1, s2, hdr = fft_sym(0), fft_sym(1), fft_sym(2)
    ic = G.coarse_cfo_est(p, s1)
    if ic:
        s2, hdr = np.roll(s2, -ic), np.roll(hdr, -ic)
    H = q(G.ls_channel_estimate(p, s2))
    db = p.carrier_bins(p.data_carriers)
    hdr_eq = q(G.equalize_frame(p, hdr[None, :], H)[0])
    plen, fnum, ok = G.parse_header_bits(G.demap_symbols(hdr_eq[db], "bpsk"))
    if not ok or plen == 0 or plen > s.max_payload_bytes:
        return {"hdr_ok": False}
    n_pay = G.payload_num_symbols(p, plen)
    pay = np.array([fft_sym(3 + k) for k in range(n_pay)])
    if ic:
        pay = np.roll(pay, -ic, axis=1)
    eq = q(G.equalize_frame(p, pay, H))
    syms = eq[:, db].reshape(-1)
    nsyms = -(-plen * 8 // G.BITS_PER_SYMBOL[p.modulation])
    syms = syms[:nsyms]
    wire = G.bits_to_bytes(G.demap_symbols(syms, p.modulation)[: plen * 8])
    pts = G.constellation_points(p.modulation)
    hard = pts[np.argmin(np.abs(syms[:, None] - pts[None, :]) ** 2, axis=1)]
    return {"hdr_ok": True, "payload": wire[:-4], "frame_num": fnum,
            "crc_ok": G.check_crc32(wire),
            "evm": float(np.sqrt(np.mean(np.abs(syms - hard) ** 2)))}


def channelize_rows(x: np.ndarray, n_chan: int, taps: np.ndarray,
                    q=exact) -> np.ndarray:
    """The golden polyphase channelizer over the stream samples `x`, which
    start on a row boundary, less its first J - 1 rows (J taps an arm):
    the rows whose inputs `x` holds whole, (n_rows, n_chan)."""
    J = -(-len(taps) // n_chan)
    out = G.pfb_channelize(q(np.asarray(x, np.complex128)), n_chan, taps)
    return q(out[J - 1:])

