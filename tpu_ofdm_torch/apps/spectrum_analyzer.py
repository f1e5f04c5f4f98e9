"""Distributed spectrum analyzer: local worker, mesh worker and remote
client (counterpart of tpu_ofdm/apps/spectrum_analyzer.py).

  local  -- runs beside the capture: source -> PSD probe on the card ->
            packs avg/max PSD + metadata -> UDP to the client; polls the
            socket for control messages (retune => frequency-shift the
            source stream; a real SDR frontend would retune hardware).
  mesh   -- the multi-device wideband worker: channelize the capture over a
            (channel x time) mesh, per-channel PSD, the consensus over the
            mesh (shard.wideband.mesh_psd_step_fn), then ONE UDP publish of
            the full-band view per frame; control messages go through
            shard.distributed.broadcast_control before they apply.
  remote -- receives PSD frames, renders spectrum/waterfall in the
            terminal, can send a retune on startup.

The wire format is the JAX app's, so either end may be the JAX app.

Usage:
  python -m tpu_ofdm_torch.apps.spectrum_analyzer local --remote-host H [--file F]
  python -m tpu_ofdm_torch.apps.spectrum_analyzer mesh [--mesh CxT] [--n-chan N]
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


def mesh_for(args, dev: torch.device):
    """The analyzer's mesh: over the torch.distributed ranks after
    initialize() (started by torchrun or its environment); else --mesh CxT
    laid on `dev` alone (the device repeated); else balanced_factors over
    the CUDA devices present (one shard on the CPU)."""
    from tpu_ofdm_torch.shard import (balanced_factors, global_mesh,
                                      initialize, make_mesh)

    initialize(device=dev)
    if torch.distributed.is_initialized():
        n_c, n_t = (balanced_factors(torch.distributed.get_world_size())
                    if args.mesh is None else args.mesh)
        return global_mesh(n_c, n_t, device=dev)
    if args.mesh is not None:
        n_c, n_t = args.mesh
        return make_mesh(n_c, n_t, devices=[dev] * (n_c * n_t))
    devices = ([torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
               if dev.type == "cuda" else [dev])
    n_c, n_t = balanced_factors(len(devices))
    return make_mesh(n_c, n_t, devices=devices)


def run_mesh(args) -> int:
    """Multi-device wideband worker: channelize the capture over a (channel
    x time) mesh, per-channel PSD, the consensus over the mesh -- then ONE
    UDP publish of the full-band view per frame (instead of every worker
    shipping its PSD over a socket).  Retune control messages are
    re-broadcast to every process via broadcast_control before they
    apply."""
    import math

    from tpu_ofdm_torch.shard.distributed import broadcast_control
    from tpu_ofdm_torch.shard.wideband import flatten_band, mesh_psd_step_fn

    dev = torch.empty(0, device=args.device).device
    mesh = mesh_for(args, dev)
    n_c, n_t = mesh.shape["channel"], mesh.shape["time"]
    n_chan, nb = args.n_chan, args.chan_fft_len
    # whole PSD frames a time shard and equal channelizer pieces a shard
    quantum = math.lcm(n_chan * nb * n_t, n_chan * mesh.size)
    block_size = max(1, args.block_size // quantum) * quantum
    step, C_tail = mesh_psd_step_fn(mesh, n_chan, nb, window=args.window)

    src = make_source(args, block_size)
    pub = SpectrumPublisher((args.remote_host, args.port))
    center_freq = args.center_freq
    shift = 0.0
    tail = torch.zeros(C_tail, dtype=torch.complex64, device=dev)
    max_hold = None
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
            full, tail = step(tail, torch.as_tensor(block).to(dev))
            now = time.time()
            if now >= t_next:
                flat = flatten_band(full.cpu().numpy())
                max_hold = flat if max_hold is None else np.maximum(
                    max_hold, flat
                )
                pub.publish(center_freq, args.sample_rate, flat, max_hold, 1)
                sent += 1
                t_next = now + 1.0 / args.frame_rate
                # every process applies the SAME control stream: rank 0's
                # messages win (single process: identity)
                ctl = broadcast_control(pub.poll_control())
                for msg in ctl or []:
                    if msg.get("cmd") == "retune":
                        new = float(msg["freq"])
                        shift += (new - center_freq) / args.sample_rate
                        center_freq = new
                        print(f"retuned to {center_freq/1e6:.3f} MHz",
                              file=sys.stderr)
                    elif msg.get("cmd") == "reset":
                        max_hold = None
    except KeyboardInterrupt:
        pass
    finally:
        pub.close()
    print(
        f"published {sent} consensus frames from a {n_c}x{n_t} mesh "
        f"({n_chan} channels x {nb} bins)",
        file=sys.stderr,
    )
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


def _mesh_shape(text: str) -> tuple[int, int]:
    c, _, t = text.lower().partition("x")
    return int(c), int(t)


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

    mp = sp.add_parser("mesh", help="multi-device wideband worker")
    add_source_args(mp)
    add_device_arg(mp)
    mp.add_argument("--mesh", type=_mesh_shape, default=None,
                    help="CxT: a channel x time mesh laid on --device alone "
                         "(default: balanced over the CUDA devices present)")
    mp.add_argument("--n-chan", type=int, default=64,
                    help="channelizer channels (sharded over the mesh)")
    mp.add_argument("--chan-fft-len", type=int, default=64,
                    help="PSD bins per channel")
    mp.add_argument("--window", default="hann")
    mp.add_argument("--block-size", type=int, default=1 << 18,
                    help="wideband samples per step (rounded to a whole "
                         "number of per-channel PSD frames per time shard)")
    mp.add_argument("--remote-host", default="127.0.0.1")
    mp.add_argument("--port", type=int, default=46864)
    mp.add_argument("--center-freq", type=float, default=0.0)
    mp.add_argument("--sample-rate", type=float, default=1e6)
    mp.add_argument("--frame-rate", type=float, default=10.0)
    mp.add_argument("--blocks", type=int, default=0)

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
    if args.mode == "mesh":
        return run_mesh(args)
    return run_remote(args)


if __name__ == "__main__":
    raise SystemExit(main())
