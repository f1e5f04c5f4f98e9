"""Distributed spectrum analyzer: local worker + remote client (counterpart
of tpu_ofdm/apps/spectrum_analyzer.py, its local and remote modes).

  local  -- runs beside the capture: source -> PSD probe on the card ->
            packs avg/max PSD + metadata -> UDP to the client; polls the
            socket for control messages (retune => frequency-shift the
            source stream; a real SDR frontend would retune hardware).
  remote -- receives PSD frames, renders spectrum/waterfall in the
            terminal, can send a retune on startup.

The wire format is the JAX app's, so either end may be the JAX app.  The
JAX app's `mesh` mode (a worker over a device mesh) needs the sharded
modules and is not ported yet.

Usage:
  python -m tpu_ofdm_torch.apps.spectrum_analyzer local --remote-host H [--file F]
  python -m tpu_ofdm_torch.apps.spectrum_analyzer remote [--port P]

`remote --port 0` binds a free port; remote names the port it bound on
stderr once the socket is up.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np
import torch

from tpu_ofdm_torch.apps.common import (add_device_arg, add_source_args,
                                        make_source, to_host)
from tpu_ofdm_torch.io import SpectrumPublisher, SpectrumSubscriber
from tpu_ofdm_torch.spectrum import (render_ascii, render_spectrum_line,
                                     spectrum_probe_block)
from tpu_ofdm_torch.stream.executor import StreamExecutor


def run_local(args) -> int:
    dev = torch.empty(0, device=args.device).device
    ex = StreamExecutor(
        spectrum_probe_block(args.fft_len, window=args.window),
        args.block_size, device=dev,
    )
    src = make_source(args, args.block_size)
    pub = SpectrumPublisher((args.remote_host, args.port))
    center_freq = args.center_freq
    shift = 0.0  # software retune offset (fraction of fs)
    sent = 0
    t_next = time.time()
    try:
        for i, block in enumerate(src):
            if args.blocks and i >= args.blocks:
                break
            if shift:
                n = np.arange(len(block))
                block = (block * np.exp(-2j * np.pi * shift * n)).astype(
                    np.complex64
                )
            out = ex.push(block)
            now = time.time()
            if now >= t_next:
                s = to_host(out)
                pub.publish(
                    center_freq, args.sample_rate, s.avg_db.numpy(),
                    s.max_db.numpy(), int(s.n_frames),
                )
                sent += 1
                t_next = now + 1.0 / args.frame_rate
                for msg in pub.poll_control():
                    if msg.get("cmd") == "retune":
                        new = float(msg["freq"])
                        shift += (new - center_freq) / args.sample_rate
                        center_freq = new
                        print(f"retuned to {center_freq/1e6:.3f} MHz",
                              file=sys.stderr)
                    elif msg.get("cmd") == "reset":
                        ex.reset()
    except KeyboardInterrupt:
        pass
    finally:
        pub.close()
    print(f"published {sent} spectrum frames", file=sys.stderr)
    return 0


def run_remote(args) -> int:
    sub = SpectrumSubscriber(bind_port=args.port)
    print(f"receiving spectrum frames on udp port {sub.port}",
          file=sys.stderr, flush=True)
    if args.retune:
        print("will request retune after first frame", file=sys.stderr)
    rows = []
    got = 0
    try:
        while args.frames == 0 or got < args.frames:
            fr = sub.receive(timeout=args.timeout)
            if fr is None:
                print("timeout waiting for spectrum frames", file=sys.stderr)
                return 1
            got += 1
            if args.retune and got == 1:
                sub.send_control({"cmd": "retune", "freq": args.retune})
            psd = np.roll(fr.avg_db, len(fr.avg_db) // 2)  # center DC
            rows.append(psd)
            rows = rows[-args.depth:]
            line = render_spectrum_line(psd, width=args.width)
            lo = fr.center_freq - fr.sample_rate / 2
            hi = fr.center_freq + fr.sample_rate / 2
            print(
                f"#{fr.seq:6d} {lo/1e6:9.3f}..{hi/1e6:9.3f} MHz "
                f"peak {fr.max_db.max():6.1f} dB |{line}|"
            )
            if args.waterfall and got % args.depth == 0:
                print(render_ascii(np.stack(rows), width=args.width))
    except KeyboardInterrupt:
        pass
    finally:
        sub.close()
    return 0


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="spectrum_analyzer", description=__doc__)
    sp = p.add_subparsers(dest="mode", required=True)

    lp = sp.add_parser("local", help="capture-side worker")
    add_source_args(lp)
    add_device_arg(lp)
    lp.add_argument("--fft-len", type=int, default=1024)
    lp.add_argument("--window", default="blackman_harris")
    lp.add_argument("--block-size", type=int, default=1 << 17)
    lp.add_argument("--remote-host", default="127.0.0.1")
    lp.add_argument("--port", type=int, default=46864)
    lp.add_argument("--center-freq", type=float, default=0.0)
    lp.add_argument("--sample-rate", type=float, default=1e6)
    lp.add_argument("--frame-rate", type=float, default=10.0,
                    help="spectrum updates per second")
    lp.add_argument("--blocks", type=int, default=0,
                    help="stop after N blocks (0 = endless)")

    rp = sp.add_parser("remote", help="display-side client")
    rp.add_argument("--port", type=int, default=46864,
                    help="UDP port to bind (0 = any free one)")
    rp.add_argument("--frames", type=int, default=0,
                    help="stop after N frames (0 = endless)")
    rp.add_argument("--timeout", type=float, default=5.0)
    rp.add_argument("--width", type=int, default=80)
    rp.add_argument("--depth", type=int, default=24,
                    help="waterfall rows")
    rp.add_argument("--waterfall", action="store_true")
    rp.add_argument("--retune", type=float, default=None,
                    help="request this center freq from the worker")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.mode == "local":
        return run_local(args)
    return run_remote(args)


if __name__ == "__main__":
    raise SystemExit(main())
