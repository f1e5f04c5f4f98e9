"""Static configuration: frozen dataclasses and the derived frame constants.

Counterpart of tpu_ofdm/config.py, kept as this package's own copy so the
port imports nothing of the JAX package.  It is numpy-only, and builds every
constant exactly as the JAX package does (sync words, carrier maps, pilot
values and frame geometry match the golden model in
tests/golden/golden_ofdm.py bit for bit; the tests compare the two specs
attribute by attribute).  Everything a spec holds is a numpy array or a
Python scalar; the port turns what it needs into tensors on the device of
the data (see each op's cached constants).
"""

from __future__ import annotations

import dataclasses
import functools
from dataclasses import dataclass

import numpy as np

BITS_PER_SYMBOL = {"bpsk": 1, "qpsk": 2, "qam16": 4, "qam64": 6}

HEADER_LEN_BITS = 12
HEADER_NUM_BITS = 12
HEADER_CRC_BITS = 8
HEADER_BITS = HEADER_LEN_BITS + HEADER_NUM_BITS + HEADER_CRC_BITS  # 32


def default_occupied_carriers(fft_len: int) -> tuple[int, ...]:
    """~3/4 occupancy symmetric span, DC unused (64 -> -26..26 sans 0)."""
    half = int(fft_len * 26 / 64)
    return tuple(range(-half, 0)) + tuple(range(1, half + 1))


def default_pilot_carriers(fft_len: int) -> tuple[int, ...]:
    scale = max(fft_len // 64, 1)
    return tuple(int(c * scale) for c in (-21, -7, 7, 21))


@dataclass(frozen=True)
class OfdmConfig:
    """OFDM waveform parameters (fft_len, cp_len, carriers, pilots,
    modulation, packet length).  Hashable, so specs and device constants
    can be cached per config."""

    fft_len: int = 64
    cp_len: int = 16
    modulation: str = "bpsk"
    occupied_carriers: tuple[int, ...] | None = None
    pilot_carriers: tuple[int, ...] | None = None
    pilot_symbols: tuple[complex, ...] | None = None
    sync_seed: int = 42
    scale: float = 1.0
    max_payload_bytes: int = 256   # wire bytes incl. CRC32; bounds frame size
    sync_threshold: float = 0.6
    max_int_cfo: int = 4
    rolloff_len: int = 0   # raised-cosine flank between symbols, <= cp_len

    def __post_init__(self):
        if not 0 <= self.rolloff_len <= self.cp_len:
            raise ValueError("rolloff_len must be in [0, cp_len]")
        # the detection's plateau-centre lag c = cp - cp//2 must stay within
        # one window of L = fft_len/2 samples
        if not 0 <= self.cp_len < self.fft_len:
            raise ValueError("cp_len must be in [0, fft_len)")
        if self.occupied_carriers is None:
            object.__setattr__(
                self, "occupied_carriers",
                default_occupied_carriers(self.fft_len))
        if self.pilot_carriers is None:
            object.__setattr__(
                self, "pilot_carriers", default_pilot_carriers(self.fft_len))
        if self.pilot_symbols is None:
            base = (1.0, 1.0, 1.0, -1.0)
            reps = -(-len(self.pilot_carriers) // len(base))
            object.__setattr__(self, "pilot_symbols",
                               (base * reps)[: len(self.pilot_carriers)])

    @property
    def spec(self) -> "OfdmSpec":
        return _spec_for(self)


@functools.lru_cache(maxsize=64)
def _spec_for(cfg: OfdmConfig) -> "OfdmSpec":
    return OfdmSpec(cfg)


class OfdmSpec:
    """Derived constants of an OfdmConfig (numpy arrays, index maps,
    sync-word PN), computed once per config and cached."""

    def __init__(self, cfg: OfdmConfig):
        self.cfg = cfg
        self.fft_len = cfg.fft_len
        self.cp_len = cfg.cp_len
        self.sym_len = cfg.fft_len + cfg.cp_len
        self.rolloff_len = cfg.rolloff_len
        self.modulation = cfg.modulation
        self.bits_per_symbol = BITS_PER_SYMBOL[cfg.modulation]

        occ = np.asarray(cfg.occupied_carriers, dtype=np.int64)
        pil = np.asarray(cfg.pilot_carriers, dtype=np.int64)
        self.occupied_carriers = occ
        self.pilot_carriers = pil
        self.pilot_symbols = np.asarray(cfg.pilot_symbols, dtype=np.complex64)
        self.data_carriers = np.array(
            [c for c in occ if c not in set(pil.tolist())], dtype=np.int64)
        self.n_data = len(self.data_carriers)
        self.n_occupied = len(occ)

        # FFT bin index maps (numpy fft ordering)
        self.occupied_bins = np.mod(occ, cfg.fft_len)
        self.pilot_bins = np.mod(pil, cfg.fft_len)
        self.data_bins = np.mod(self.data_carriers, cfg.fft_len)

        # sync words, built as the golden model builds them
        rng = np.random.RandomState(cfg.sync_seed)
        sw1 = np.zeros(cfg.fft_len, dtype=np.complex64)
        even = occ[occ % 2 == 0]
        pn1 = rng.randint(0, 2, size=len(even)) * 2 - 1
        sw1[np.mod(even, cfg.fft_len)] = pn1 * np.sqrt(2.0)
        self.sync_word1_freq = sw1
        # sync1's spectral support (even occupied bins): the RX gates frame
        # acquisition on the energy concentrated there
        self.sync1_bins = np.mod(even, cfg.fft_len)

        rng2 = np.random.RandomState(cfg.sync_seed + 1)
        sw2 = np.zeros(cfg.fft_len, dtype=np.complex64)
        pn2 = rng2.randint(0, 2, size=len(occ)) * 2 - 1
        sw2[self.occupied_bins] = pn2
        self.sync_word2_freq = sw2

        # frame geometry, bounded by max_payload_bytes (static shapes)
        self.max_payload_bytes = cfg.max_payload_bytes
        nbits = cfg.max_payload_bytes * 8
        nsyms = -(-nbits // self.bits_per_symbol)
        self.max_payload_ofdm_syms = max(1, -(-nsyms // self.n_data))
        self.n_sync_syms = 2
        self.n_header_syms = 1
        self.max_frame_ofdm_syms = (
            self.n_sync_syms + self.n_header_syms + self.max_payload_ofdm_syms)
        self.max_frame_len = self.max_frame_ofdm_syms * self.sym_len

    def payload_ofdm_syms(self, wire_bytes: int) -> int:
        nsyms = -(-(wire_bytes * 8) // self.bits_per_symbol)
        return max(1, -(-nsyms // self.n_data))

    def frame_len(self, wire_bytes: int) -> int:
        return (self.n_sync_syms + self.n_header_syms
                + self.payload_ofdm_syms(wire_bytes)) * self.sym_len


@dataclass(frozen=True)
class StreamConfig:
    """Streaming-executor parameters: samples per step and the static
    frame-slot capacity per block."""

    block_size: int = 1 << 15          # samples per step
    max_frames_per_block: int = 8      # static frame-slot capacity per block
    dtype: str = "complex64"


def replace(cfg, **kw):
    return dataclasses.replace(cfg, **kw)
