# Frozen copy of tests/golden/golden_ofdm.py (the numpy golden chain), the
# benchmark's yardstick: later changes to the program or its tests do not reach it.

"""Frozen golden-model OFDM chain (pure numpy).

This module is the correctness oracle, standing in for golden vectors
generated by running GNU Radio: a frozen textbook implementation of the same
signal chain GNU Radio builds -- subcarrier mapping + IFFT/CP TX, Schmidl-Cox
sync, FFT demod, pilot-based equalization, constellation demapping RX.

Mirrors (by capability, not by code) the reference chain described in
SURVEY.md §2b/§3.2-3.3:
  - digital.ofdm_tx / ofdm_rx composites (gr-digital/python/digital/ofdm_txrx.py)
  - ofdm_carrier_allocator_cvc, ofdm_cyclic_prefixer
  - ofdm_sync_sc_cfb (Schmidl-Cox autocorrelator + plateau detector)
  - ofdm_chanest_vcvc (coarse int CFO + LS channel estimate)
  - ofdm_frame_equalizer_vcvc (pilot-tracking equalizer)
  - ofdm_serializer_vcvc, constellation_decoder_cb, crc32_bb
  - packet_header_ofdm (12b length, 12b frame no., CRC8)

DO NOT "optimize" this file. It is deliberately simple, direct numpy.
Every numeric convention (bit order, Gray maps, pilot values, sync-word PN,
header layout, CRC parameters) is defined HERE and the JAX framework must
match it exactly.
"""

from __future__ import annotations

import zlib
from dataclasses import dataclass, field

import numpy as np

# ----------------------------------------------------------------------------
# Constellations.  Bit order within a symbol: FIRST bit = least significant
# chunk bit as produced by bytes_to_bits (MSB-first byte unpacking), i.e. the
# bits of a symbol are consumed in stream order b0 b1 b2 ... with b0 mapping
# to the I-axis low Gray bit group first.  Unit average power.
# ----------------------------------------------------------------------------

_GRAY_2 = np.array([-1.0, 1.0])                       # 1 bit/axis: 0->-1, 1->+1
_GRAY_4 = np.array([-3.0, -1.0, 3.0, 1.0])            # 2 bits/axis Gray: 00,01,10,11
_GRAY_8 = np.array([-7.0, -5.0, -1.0, -3.0, 7.0, 5.0, 1.0, 3.0])  # 3 bits/axis Gray


def constellation_points(modulation: str) -> np.ndarray:
    """Return the 2**k constellation points indexed by the k-bit symbol value.

    Symbol value = bits interpreted MSB-first in stream order:
    value = b0*2^(k-1) + b1*2^(k-2) + ... + b_{k-1}.
    """
    if modulation == "bpsk":
        return _GRAY_2.astype(np.complex128)
    if modulation == "qpsk":
        # b0 -> I, b1 -> Q
        i = _GRAY_2[np.arange(4) >> 1]
        q = _GRAY_2[np.arange(4) & 1]
        return ((i + 1j * q) / np.sqrt(2.0)).astype(np.complex128)
    if modulation == "qam16":
        # b0 b1 -> I (Gray), b2 b3 -> Q (Gray)
        idx = np.arange(16)
        i = _GRAY_4[(idx >> 2) & 0x3]
        q = _GRAY_4[idx & 0x3]
        return ((i + 1j * q) / np.sqrt(10.0)).astype(np.complex128)
    if modulation == "qam64":
        idx = np.arange(64)
        i = _GRAY_8[(idx >> 3) & 0x7]
        q = _GRAY_8[idx & 0x7]
        return ((i + 1j * q) / np.sqrt(42.0)).astype(np.complex128)
    raise ValueError(f"unknown modulation {modulation!r}")


BITS_PER_SYMBOL = {"bpsk": 1, "qpsk": 2, "qam16": 4, "qam64": 6}


def bytes_to_bits(data: bytes | np.ndarray) -> np.ndarray:
    """Bytes -> bit array, MSB of each byte first."""
    arr = np.frombuffer(bytes(data), dtype=np.uint8)
    return np.unpackbits(arr)


def bits_to_bytes(bits: np.ndarray) -> bytes:
    """Bit array (MSB-first) -> bytes; length must be a multiple of 8."""
    return np.packbits(bits.astype(np.uint8)).tobytes()


def map_bits(bits: np.ndarray, modulation: str) -> np.ndarray:
    """Bits -> constellation symbols.  Pads with zero bits to a full symbol."""
    k = BITS_PER_SYMBOL[modulation]
    n = -(-len(bits) // k)
    padded = np.zeros(n * k, dtype=np.int64)
    padded[: len(bits)] = bits
    vals = padded.reshape(n, k) @ (1 << np.arange(k - 1, -1, -1))
    return constellation_points(modulation)[vals]


def demap_symbols(symbols: np.ndarray, modulation: str) -> np.ndarray:
    """Hard min-distance demap: symbols -> bits (stream order)."""
    pts = constellation_points(modulation)
    k = BITS_PER_SYMBOL[modulation]
    vals = np.argmin(np.abs(symbols[:, None] - pts[None, :]) ** 2, axis=1)
    bits = (vals[:, None] >> np.arange(k - 1, -1, -1)) & 1
    return bits.reshape(-1)


# ----------------------------------------------------------------------------
# CRCs (cf. gr-digital crc32_bb / packet_header_ofdm's CRC8)
# ----------------------------------------------------------------------------


def crc32(data: bytes) -> int:
    """IEEE 802.3 CRC32 (zlib)."""
    return zlib.crc32(bytes(data)) & 0xFFFFFFFF


def append_crc32(data: bytes) -> bytes:
    """Payload || CRC32 little-endian (4 bytes)."""
    return bytes(data) + crc32(data).to_bytes(4, "little")


def check_crc32(data_with_crc: bytes) -> bool:
    if len(data_with_crc) < 4:
        return False
    body, tail = data_with_crc[:-4], data_with_crc[-4:]
    return crc32(body) == int.from_bytes(tail, "little")


def crc8(bits: np.ndarray) -> int:
    """CRC-8 poly 0x07, init 0x00, MSB-first over a bit array."""
    reg = 0
    for b in bits:
        reg = ((reg << 1) & 0xFF) ^ (0x07 if ((reg >> 7) ^ int(b)) & 1 else 0)
    return reg


# ----------------------------------------------------------------------------
# Frame / header format (cf. packet_header_ofdm: 12b len, 12b frame no, CRC8)
# ----------------------------------------------------------------------------

HEADER_LEN_BITS = 12      # payload length in BYTES (incl. CRC32), max 4095
HEADER_NUM_BITS = 12      # frame number mod 4096
HEADER_CRC_BITS = 8
HEADER_BITS = HEADER_LEN_BITS + HEADER_NUM_BITS + HEADER_CRC_BITS  # 32


def make_header_bits(payload_len: int, frame_num: int) -> np.ndarray:
    """32 header bits: 12b length (MSB first), 12b frame number, 8b CRC8."""
    if not 0 <= payload_len < (1 << HEADER_LEN_BITS):
        raise ValueError("payload_len out of range")
    lbits = (payload_len >> np.arange(HEADER_LEN_BITS - 1, -1, -1)) & 1
    nbits = ((frame_num % (1 << HEADER_NUM_BITS))
             >> np.arange(HEADER_NUM_BITS - 1, -1, -1)) & 1
    body = np.concatenate([lbits, nbits]).astype(np.int64)
    c = crc8(body)
    cbits = (c >> np.arange(HEADER_CRC_BITS - 1, -1, -1)) & 1
    return np.concatenate([body, cbits])


def parse_header_bits(bits: np.ndarray) -> tuple[int, int, bool]:
    """-> (payload_len, frame_num, crc_ok)."""
    bits = np.asarray(bits[:HEADER_BITS]).astype(np.int64)
    body = bits[: HEADER_LEN_BITS + HEADER_NUM_BITS]
    plen = int(body[:HEADER_LEN_BITS] @ (1 << np.arange(HEADER_LEN_BITS - 1, -1, -1)))
    fnum = int(body[HEADER_LEN_BITS:] @ (1 << np.arange(HEADER_NUM_BITS - 1, -1, -1)))
    got = int(bits[HEADER_LEN_BITS + HEADER_NUM_BITS:]
              @ (1 << np.arange(HEADER_CRC_BITS - 1, -1, -1)))
    return plen, fnum, got == crc8(body)


# ----------------------------------------------------------------------------
# OFDM parameters (cf. ofdm_carrier_allocator_cvc defaults / 802.11-like map)
# ----------------------------------------------------------------------------


def default_occupied_carriers(fft_len: int) -> np.ndarray:
    """Logical carrier indices (negative = below DC), DC unused, ~3/4 occupancy.

    For fft_len=64 this reproduces the classic -26..26 (sans DC) span.
    """
    half = int(fft_len * 26 / 64)
    idx = np.concatenate([np.arange(-half, 0), np.arange(1, half + 1)])
    return idx


def default_pilot_carriers(fft_len: int) -> np.ndarray:
    scale = fft_len // 64
    base = np.array([-21, -7, 7, 21])
    return base * max(scale, 1)


DEFAULT_PILOT_SYMBOLS = np.array([1.0, 1.0, 1.0, -1.0])


@dataclass
class GoldenOfdmParams:
    fft_len: int = 64
    cp_len: int = 16
    modulation: str = "bpsk"
    occupied_carriers: np.ndarray = None  # logical indices incl. pilots
    pilot_carriers: np.ndarray = None
    pilot_symbols: np.ndarray = None
    sync_seed: int = 42
    scale: float = 1.0  # output amplitude scale (multiply_const_cc equivalent)

    # derived
    data_carriers: np.ndarray = field(init=False)

    def __post_init__(self):
        if self.occupied_carriers is None:
            self.occupied_carriers = default_occupied_carriers(self.fft_len)
        if self.pilot_carriers is None:
            self.pilot_carriers = default_pilot_carriers(self.fft_len)
        if self.pilot_symbols is None:
            reps = -(-len(self.pilot_carriers) // len(DEFAULT_PILOT_SYMBOLS))
            self.pilot_symbols = np.tile(DEFAULT_PILOT_SYMBOLS, reps)[
                : len(self.pilot_carriers)
            ]
        self.occupied_carriers = np.asarray(self.occupied_carriers)
        self.pilot_carriers = np.asarray(self.pilot_carriers)
        self.pilot_symbols = np.asarray(self.pilot_symbols, dtype=np.complex128)
        self.data_carriers = np.array(
            [c for c in self.occupied_carriers if c not in set(self.pilot_carriers)]
        )

    @property
    def n_data(self) -> int:
        return len(self.data_carriers)

    @property
    def sym_len(self) -> int:
        return self.fft_len + self.cp_len

    def carrier_bins(self, logical: np.ndarray) -> np.ndarray:
        """Logical carrier index -> FFT bin index (numpy fft order)."""
        return np.mod(np.asarray(logical), self.fft_len)

    # -- sync words (deterministic PN; cf. ofdm_txrx._make_sync_word1/2) -----

    def sync_word1_freq(self) -> np.ndarray:
        """Freq-domain sync word 1: BPSK PN * sqrt(2) on EVEN occupied
        carriers only -> time domain has two identical halves (Schmidl-Cox)."""
        rng = np.random.RandomState(self.sync_seed)
        sw = np.zeros(self.fft_len, dtype=np.complex128)
        even = self.occupied_carriers[self.occupied_carriers % 2 == 0]
        pn = rng.randint(0, 2, size=len(even)) * 2 - 1
        sw[self.carrier_bins(even)] = pn * np.sqrt(2.0)
        return sw

    def sync_word2_freq(self) -> np.ndarray:
        """Freq-domain sync word 2: BPSK PN on ALL occupied carriers (for LS
        channel estimation)."""
        rng = np.random.RandomState(self.sync_seed + 1)
        sw = np.zeros(self.fft_len, dtype=np.complex128)
        pn = rng.randint(0, 2, size=len(self.occupied_carriers)) * 2 - 1
        sw[self.carrier_bins(self.occupied_carriers)] = pn
        return sw


# ----------------------------------------------------------------------------
# TX chain (cf. §3.2: crc32 -> header gen -> map -> carrier alloc -> IFFT -> CP)
# ----------------------------------------------------------------------------


def allocate_carriers(p: GoldenOfdmParams, data_syms: np.ndarray) -> np.ndarray:
    """Data symbols -> (n_ofdm_syms, fft_len) freq-domain grid with pilots.

    Pads the final OFDM symbol's unused data carriers with zeros.
    """
    nd = p.n_data
    n_syms = max(1, -(-len(data_syms) // nd))
    grid = np.zeros((n_syms, p.fft_len), dtype=np.complex128)
    padded = np.zeros(n_syms * nd, dtype=np.complex128)
    padded[: len(data_syms)] = data_syms
    grid[:, p.carrier_bins(p.data_carriers)] = padded.reshape(n_syms, nd)
    grid[:, p.carrier_bins(p.pilot_carriers)] = p.pilot_symbols
    return grid


def ofdm_modulate(p: GoldenOfdmParams, grid: np.ndarray) -> np.ndarray:
    """(n, fft_len) freq grid -> serialized time samples with CP.

    IFFT normalization: 1/sqrt(fft_len) (unitary power-ish, matches the
    JAX implementation; the reference's fft_vcc uses unnormalized FFTW +
    explicit scale, net effect identical up to self.scale).
    """
    td = np.fft.ifft(grid, axis=1) * np.sqrt(p.fft_len)
    with_cp = np.concatenate([td[:, -p.cp_len:], td], axis=1)
    return with_cp.reshape(-1) * p.scale


def tx_frame(p: GoldenOfdmParams, payload: bytes, frame_num: int = 0) -> np.ndarray:
    """Full TX: payload bytes -> time-domain frame samples.

    Frame layout: [sync1 | sync2 | header symbol | payload symbols], each
    OFDM symbol CP-prefixed.
    """
    wire = append_crc32(payload)
    hdr_bits = make_header_bits(len(wire), frame_num)
    if p.n_data < HEADER_BITS:
        raise ValueError("need >= 32 data carriers for the header symbol")
    hdr_syms = map_bits(
        np.concatenate([hdr_bits, np.zeros(p.n_data - HEADER_BITS, dtype=np.int64)]),
        "bpsk",
    )
    pay_syms = map_bits(bytes_to_bits(wire), p.modulation)

    hdr_grid = allocate_carriers(p, hdr_syms)
    pay_grid = allocate_carriers(p, pay_syms)
    sync_grid = np.stack([p.sync_word1_freq(), p.sync_word2_freq()])
    grid = np.concatenate([sync_grid, hdr_grid, pay_grid], axis=0)
    return ofdm_modulate(p, grid)


def payload_num_symbols(p: GoldenOfdmParams, payload_len_bytes: int) -> int:
    """Number of payload OFDM symbols for a given wire length (bytes incl CRC)."""
    nbits = payload_len_bytes * 8
    nsym = -(-nbits // BITS_PER_SYMBOL[p.modulation])
    return max(1, -(-nsym // p.n_data))


# ----------------------------------------------------------------------------
# Channel models (cf. channels::channel_model: AWGN + CFO + timing + multipath)
# ----------------------------------------------------------------------------


def channel(
    samples: np.ndarray,
    snr_db: float | None = None,
    cfo: float = 0.0,            # carrier freq offset in SUBCARRIER units
    fft_len: int = 64,
    timing_offset: int = 0,      # integer sample delay (zeros prepended)
    multipath: np.ndarray | None = None,  # FIR taps, taps[0] = LOS
    phase: float = 0.0,
    seed: int = 0,
) -> np.ndarray:
    rng = np.random.RandomState(seed)
    x = samples
    if multipath is not None and len(multipath) > 1:
        x = np.convolve(x, multipath)[: len(x)]
    n = np.arange(len(x))
    x = x * np.exp(1j * (2 * np.pi * cfo * n / fft_len + phase))
    if timing_offset:
        x = np.concatenate([np.zeros(timing_offset, dtype=x.dtype), x])
    if snr_db is not None:
        sig_pow = np.mean(np.abs(samples) ** 2)
        noise_pow = sig_pow / (10 ** (snr_db / 10))
        noise = (rng.randn(len(x)) + 1j * rng.randn(len(x))) * np.sqrt(noise_pow / 2)
        x = x + noise
    return x


# ----------------------------------------------------------------------------
# RX chain (cf. §3.3)
# ----------------------------------------------------------------------------


def schmidl_cox_metric(p: GoldenOfdmParams, r: np.ndarray):
    """Schmidl-Cox autocorrelation (cf. ofdm_sync_sc_cfb_impl.cc structure:
    delay-conjugate-multiply -> moving sum; energy -> moving sum; ratio).

    Returns (M, P) where M[d] = |P(d)|^2 / R(d)^2 and
    P(d) = sum_{m<L} conj(r[d+m]) r[d+m+L], L = fft_len/2.
    """
    L = p.fft_len // 2
    n = len(r) - 2 * L
    if n <= 0:
        return np.zeros(0), np.zeros(0, dtype=np.complex128)
    prod = np.conj(r[:-L]) * r[L:]
    energy = np.abs(r[L:]) ** 2
    kern = np.ones(L)
    P = np.convolve(prod, kern)[L - 1: L - 1 + n]
    R = np.convolve(energy, kern)[L - 1: L - 1 + n]
    M = np.abs(P) ** 2 / np.maximum(R, 1e-12) ** 2
    return M, P


def detect_frame(p: GoldenOfdmParams, r: np.ndarray, threshold: float = 0.6):
    """Plateau detection (cf. plateau_detector_fb): the metric plateaus for
    ~cp_len samples starting at the first sample of sync1's CP.  Returns
    (start_of_sync1_fft_part, fine_cfo_subcarriers) or None.

    The detected start points at the first sample AFTER the CP of sync word 1
    (i.e. where the FFT window for sync1 should begin).
    """
    M, P = schmidl_cox_metric(p, r)
    if len(M) == 0:
        return None
    # Suppress the low-energy region where the normalized metric is unreliable
    L = p.fft_len // 2
    energy = np.convolve(np.abs(r[L:]) ** 2, np.ones(L))[L - 1: L - 1 + len(M)]
    M = np.where(energy > 0.1 * energy.max(), M, 0.0)
    d_star = int(np.argmax(M))
    if M[d_star] < threshold:
        return None
    # Expand the plateau around the peak (metric is ~flat over the CP span)
    lo = d_star
    while lo > 0 and M[lo - 1] > 0.9 * M[d_star]:
        lo -= 1
    hi = d_star
    while hi < len(M) - 1 and M[hi + 1] > 0.9 * M[d_star]:
        hi += 1
    mid = (lo + hi) // 2  # ~ sync1 CP start + cp_len/2
    fine_cfo = np.angle(P[mid]) / np.pi  # in subcarrier units
    backoff = min(4, p.cp_len // 4)  # start slightly inside CP (ISI margin)
    start = mid + p.cp_len - p.cp_len // 2 - backoff
    return start, fine_cfo


def coarse_cfo_est(p: GoldenOfdmParams, rx_sync1_fd: np.ndarray, max_shift: int = 4):
    """Integer CFO search (cf. ofdm_chanest_vcvc): correlate |RX sync1| with
    the known sync1 magnitude pattern shifted by -max..max EVEN bins."""
    ref = np.abs(p.sync_word1_freq())
    best, best_v = 0, -np.inf
    for s in range(-max_shift, max_shift + 1):
        v = np.abs(np.vdot(np.roll(ref, s), np.abs(rx_sync1_fd)))
        if v > best_v:
            best, best_v = s, v
    return best


def ls_channel_estimate(p: GoldenOfdmParams, rx_sync2_fd: np.ndarray) -> np.ndarray:
    """LS estimate on occupied carriers from sync word 2; others -> 0."""
    H = np.zeros(p.fft_len, dtype=np.complex128)
    bins = p.carrier_bins(p.occupied_carriers)
    X = p.sync_word2_freq()[bins]
    H[bins] = rx_sync2_fd[bins] / X
    return H


def equalize_frame(
    p: GoldenOfdmParams, grid: np.ndarray, H: np.ndarray
) -> np.ndarray:
    """Per-symbol equalization: divide by H, then correct the common phase
    rotation tracked from pilots (cf. ofdm_frame_equalizer_vcvc with a
    simplified pilot-phase tracker)."""
    out = np.zeros_like(grid)
    pb = p.carrier_bins(p.pilot_carriers)
    Hs = np.where(np.abs(H) > 1e-9, H, 1.0)
    for i in range(grid.shape[0]):
        eq = grid[i] / Hs
        rot = np.vdot(p.pilot_symbols, eq[pb])  # sum conj(pilot)*rx
        ph = rot / np.abs(rot) if np.abs(rot) > 1e-12 else 1.0
        out[i] = eq * np.conj(ph)
    return out


def rx_frame(
    p: GoldenOfdmParams,
    r: np.ndarray,
    threshold: float = 0.6,
    max_frames_syms: int = 64,
):
    """Full RX: time samples -> dict with recovered payload + diagnostics.

    Returns None if no frame detected or header CRC fails.
    """
    det = detect_frame(p, r, threshold)
    if det is None:
        return None
    start, fine_cfo = det
    n = np.arange(len(r))
    r = r * np.exp(-2j * np.pi * fine_cfo * n / p.fft_len)

    def fft_sym(k):  # k-th OFDM symbol's FFT (window skips CP)
        a = start + k * p.sym_len
        if a + p.fft_len > len(r):
            return None
        return np.fft.fft(r[a: a + p.fft_len]) / np.sqrt(p.fft_len)

    s1 = fft_sym(0)
    s2 = fft_sym(1)
    if s1 is None or s2 is None:
        return None
    ic = coarse_cfo_est(p, s1)
    if ic != 0:  # compensate integer CFO by rolling bins
        s2 = np.roll(s2, -ic)
    H = ls_channel_estimate(p, s2)

    hdr_fd = fft_sym(2)
    if hdr_fd is None:
        return None
    if ic != 0:
        hdr_fd = np.roll(hdr_fd, -ic)
    hdr_eq = equalize_frame(p, hdr_fd[None, :], H)[0]
    db = p.carrier_bins(p.data_carriers)
    hdr_bits = demap_symbols(hdr_eq[db], "bpsk")
    plen, fnum, ok = parse_header_bits(hdr_bits)
    if not ok or plen == 0:
        return None
    n_pay = payload_num_symbols(p, plen)
    n_pay = min(n_pay, max_frames_syms)

    pay_fd = []
    for k in range(n_pay):
        s = fft_sym(3 + k)
        if s is None:
            return None
        pay_fd.append(np.roll(s, -ic) if ic != 0 else s)
    pay_eq = equalize_frame(p, np.array(pay_fd), H)
    data_syms = pay_eq[:, db].reshape(-1)
    nbits = plen * 8
    nsyms = -(-nbits // BITS_PER_SYMBOL[p.modulation])
    bits = demap_symbols(data_syms[:nsyms], p.modulation)[:nbits]
    wire = bits_to_bytes(bits)
    crc_ok = check_crc32(wire)

    # EVM vs hard decisions
    pts = constellation_points(p.modulation)
    hard = pts[np.argmin(np.abs(data_syms[:nsyms, None] - pts[None, :]) ** 2, axis=1)]
    evm = float(np.sqrt(np.mean(np.abs(data_syms[:nsyms] - hard) ** 2)))

    return {
        "payload": wire[:-4],
        "crc_ok": crc_ok,
        "frame_num": fnum,
        "fine_cfo": fine_cfo,
        "int_cfo": ic,
        "start": start,
        "evm": evm,
        "H": H,
        "data_syms": data_syms[:nsyms],
    }


# ----------------------------------------------------------------------------
# Spectrum path golden (cf. logpwrfft_c: window+FFT -> |.|^2 -> nlog10 -> IIR)
# ----------------------------------------------------------------------------


def hann(n: int) -> np.ndarray:
    return 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)


def log_pwr_fft(
    x: np.ndarray, fft_len: int, avg_alpha: float = 1.0, window: str = "hann"
) -> np.ndarray:
    """PSD frames in dB: stream_to_vector -> window+FFT -> |.|^2/norm -> 10log10,
    single-pole IIR averaging across frames with alpha (1.0 = no averaging).

    Normalization matches gr logpwrfft: divide by window power and fft_len.
    """
    n = len(x) // fft_len
    frames = x[: n * fft_len].reshape(n, fft_len)
    w = hann(fft_len) if window == "hann" else np.ones(fft_len)
    wf = np.fft.fft(frames * w, axis=1)
    pwr = (np.abs(wf) ** 2) / (np.sum(w ** 2) * fft_len)
    out = np.zeros_like(pwr)
    acc = pwr[0]
    for i in range(n):
        acc = avg_alpha * pwr[i] + (1 - avg_alpha) * acc
        out[i] = acc
    return 10.0 * np.log10(np.maximum(out, 1e-20))


def pfb_channelize(x: np.ndarray, n_chan: int, taps: np.ndarray) -> np.ndarray:
    """Golden polyphase channelizer (cf. pfb_channelizer_ccf, critically
    sampled): returns (n_out, n_chan) channel samples.

    Direct (slow) implementation: polyphase decompose taps and input,
    filter each arm, then IFFT across arms.  Channel k is centered at
    k * fs / n_chan.
    """
    ntaps = len(taps)
    taps_per_arm = -(-ntaps // n_chan)
    tp = np.zeros(n_chan * taps_per_arm)
    tp[:ntaps] = taps
    poly = tp.reshape(taps_per_arm, n_chan)  # poly[j, arm]

    n_out = len(x) // n_chan
    xp = x[: n_out * n_chan].reshape(n_out, n_chan)
    # arm a at output time m consumes x[m*N + (N-1-a)] (commutator runs backwards)
    xa = xp[:, ::-1]  # (n_out, arm)
    arm_out = np.zeros((n_out, n_chan), dtype=np.complex128)
    for a in range(n_chan):
        arm_out[:, a] = np.convolve(xa[:, a], poly[:, a])[:n_out]
    return np.fft.ifft(arm_out, axis=1) * n_chan


def lowpass_taps(n_chan: int, taps_per_arm: int = 8, beta: float = 9.0) -> np.ndarray:
    """Prototype lowpass for the channelizer: windowed sinc, cutoff 1/(2*n_chan)
    of fs, unity DC gain per arm (cf. firdes.low_pass with Kaiser window)."""
    ntaps = n_chan * taps_per_arm
    n = np.arange(ntaps) - (ntaps - 1) / 2
    h = np.sinc(n / n_chan) * np.kaiser(ntaps, beta)
    return h / np.sum(h) * n_chan
