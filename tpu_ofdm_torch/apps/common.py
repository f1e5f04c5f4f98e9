"""Shared CLI plumbing for the apps (counterpart of
tpu_ofdm/apps/common.py).  Every app takes --device, the card unless the
caller names the CPU."""

from __future__ import annotations

import argparse

import numpy as np
import torch

from tpu_ofdm_torch.config import OfdmConfig
from tpu_ofdm_torch.io import file_source, noise_source, sig_source
from tpu_ofdm_torch.stream.executor import tree_map


def add_device_arg(p: argparse.ArgumentParser):
    p.add_argument("--device", default="cuda",
                   help="torch device the stream runs on (cuda or cpu)")


def add_source_args(p: argparse.ArgumentParser):
    p.add_argument("--file", help="raw capture file (see --format)")
    p.add_argument(
        "--format", default="c64", choices=["c64", "f32", "i16"],
        help="file sample format",
    )
    p.add_argument("--tone", type=float, default=None,
                   help="synthetic tone at this fraction of fs")
    p.add_argument("--noise", type=float, default=None,
                   help="synthetic noise amplitude")
    p.add_argument("--repeat", action="store_true", help="loop file source")


def make_source(args, block_size: int):
    """Source iterator from CLI args; synthetic sources compose additively."""
    if args.file:
        return file_source(args.file, block_size, args.format, repeat=args.repeat)
    tone = args.tone
    noise_amp = args.noise if args.noise is not None else (
        0.0 if tone is not None else 1.0
    )

    def gen():
        t = sig_source(block_size, tone) if tone is not None else None
        n = noise_source(block_size, noise_amp) if noise_amp > 0 else None
        while True:
            x = np.zeros(block_size, np.complex64)
            if t is not None:
                x += next(t)
            if n is not None:
                x += next(n)
            yield x

    return gen()


def add_ofdm_args(p: argparse.ArgumentParser):
    p.add_argument("--fft-len", type=int, default=64)
    p.add_argument("--cp-len", type=int, default=16)
    p.add_argument(
        "--modulation", default="qpsk",
        choices=["bpsk", "qpsk", "qam16", "qam64"],
    )
    p.add_argument("--max-payload", type=int, default=256,
                   help="max wire bytes per frame (incl. CRC32)")


def ofdm_config(args) -> OfdmConfig:
    return OfdmConfig(
        fft_len=args.fft_len,
        cp_len=args.cp_len,
        modulation=args.modulation,
        max_payload_bytes=args.max_payload,
    )


def to_host(tree):
    """Every tensor leaf of a Block's output tree, copied to the CPU."""
    return tree_map(lambda a: a.cpu() if isinstance(a, torch.Tensor) else a,
                    tree)
