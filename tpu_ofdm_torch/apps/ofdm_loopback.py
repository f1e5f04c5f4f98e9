"""OFDM loopback demo: TX frames -> channel -> streaming RX, print stats
(counterpart of tpu_ofdm/apps/ofdm_loopback.py).

Usage:
  python -m tpu_ofdm_torch.apps.ofdm_loopback --frames 10 --snr 20 --cfo 0.1
  python -m tpu_ofdm_torch.apps.ofdm_loopback --frames 3 --device cpu

The channel's noise comes from a torch.Generator seeded with --seed, so
with --snr the realization differs from the JAX app's (jax.random); the
frames, starts and payloads are the same.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from tpu_ofdm_torch.apps.common import add_device_arg, add_ofdm_args, ofdm_config
from tpu_ofdm_torch.config import StreamConfig
from tpu_ofdm_torch.modem.rx_stream import (collect_frames, history_len,
                                            rx_stream_block)
from tpu_ofdm_torch.modem.tx import tx_frames
from tpu_ofdm_torch.ops.channel import channel_model
from tpu_ofdm_torch.stream.executor import StreamExecutor


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ofdm_loopback", description=__doc__)
    add_ofdm_args(p)
    add_device_arg(p)
    p.add_argument("--frames", type=int, default=5)
    p.add_argument("--payload", default="the quick brown fox jumps over the lazy dog")
    p.add_argument("--snr", type=float, default=None, help="AWGN SNR in dB")
    p.add_argument("--cfo", type=float, default=0.0,
                   help="carrier offset in subcarrier units")
    p.add_argument("--multipath", action="store_true",
                   help="apply a 3-tap multipath channel")
    p.add_argument("--gap", type=int, default=500,
                   help="silence samples between frames")
    p.add_argument("--block-size", type=int, default=1 << 14)
    p.add_argument("--equalizer", default="pilot_phase",
                   choices=["pilot_phase", "simpledfe"])
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args(argv)

    cfg = ofdm_config(args)
    spec = cfg.spec
    dev = torch.empty(0, device=args.device).device

    # --- TX ---------------------------------------------------------------
    payloads = [
        f"[{i:03d}] {args.payload}".encode()[: cfg.max_payload_bytes - 4]
        for i in range(args.frames)
    ]
    cap = cfg.max_payload_bytes - 4
    bufs = np.zeros((args.frames, cap), np.uint8)
    lens = np.zeros(args.frames, np.int32)
    for i, pl in enumerate(payloads):
        bufs[i, : len(pl)] = np.frombuffer(pl, np.uint8)
        lens[i] = len(pl)
    fr = tx_frames(spec, torch.as_tensor(bufs, device=dev),
                   torch.as_tensor(lens, device=dev),
                   torch.arange(args.frames, dtype=torch.int32, device=dev))
    samples, n_samples = fr.samples.cpu().numpy(), fr.n_samples.tolist()
    parts = []
    for i in range(args.frames):
        parts.append(np.zeros(args.gap, np.complex64))
        parts.append(samples[i][: n_samples[i]])
    parts.append(np.zeros(args.gap, np.complex64))
    clean = torch.as_tensor(np.concatenate(parts), device=dev)

    # --- channel ----------------------------------------------------------
    taps = np.array([1.0, 0.25 - 0.15j, 0.12j]) if args.multipath else None
    gen = torch.Generator(device=dev).manual_seed(args.seed)
    rx = channel_model(gen, clean, snr_db=args.snr, cfo=args.cfo,
                       fft_len=cfg.fft_len, taps=taps)

    # --- RX ---------------------------------------------------------------
    sc = StreamConfig(block_size=args.block_size, max_frames_per_block=8)
    ex = StreamExecutor(rx_stream_block(spec, sc, equalizer=args.equalizer),
                        sc.block_size, device=dev)
    frames = collect_frames(ex.run(rx, drain=True), block_size=sc.block_size,
                            hist=history_len(spec))

    ok = 0
    for f in frames:
        status = "OK " if f["crc_ok"] else "CRC-FAIL"
        print(
            f"{status} #{f['frame_num']:3d} start={f['abs_start']:7d} "
            f"evm={f['evm']:.4f} cfo={f['fine_cfo']:+.4f} "
            f"payload={f['payload'][:48]!r}"
        )
        if f["crc_ok"] and f["payload"] in payloads:
            ok += 1
    print(
        f"recovered {ok}/{args.frames} frames "
        f"({cfg.modulation}, fft={cfg.fft_len}, snr={args.snr}, "
        f"cfo={args.cfo}, multipath={args.multipath})",
        file=sys.stderr,
    )
    return 0 if ok == args.frames else 1


if __name__ == "__main__":
    raise SystemExit(main())
