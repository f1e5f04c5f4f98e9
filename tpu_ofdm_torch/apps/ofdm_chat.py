"""Chat / file transfer over an OFDM link, samples riding UDP between hosts
(counterpart of tpu_ofdm/apps/ofdm_chat.py).

The modulated sample stream travels over a UdpSampleLink -- the simulated
air interface standing in for the SDR path.  Both ends speak the JAX app's
wire format, so either end may be the JAX app.

Two processes:
  python -m tpu_ofdm_torch.apps.ofdm_chat listen --port 47000
  python -m tpu_ofdm_torch.apps.ofdm_chat send --remote-host H --port 47000 -m "hi"

`listen --port 0` binds a free port; listen names the port it bound on
stderr once the socket is up.

`send` modulates each message as one OFDM frame and ships the samples;
`listen` runs the streaming RX over received sample blocks and prints
decoded messages.  Both take --device (the card unless cpu is named).
"""

from __future__ import annotations

import argparse
import sys

import torch

from tpu_ofdm_torch.apps.common import (add_device_arg, add_ofdm_args,
                                        ofdm_config, to_host)
from tpu_ofdm_torch.config import StreamConfig
from tpu_ofdm_torch.io import UdpSampleLink
from tpu_ofdm_torch.modem.rx_stream import collect_frames, rx_stream_block
from tpu_ofdm_torch.modem.tx_stream import queue_tx_in, tx_stream_block
from tpu_ofdm_torch.stream.executor import StreamExecutor


def run_send(args) -> int:
    """Continuous executor-driven transmitter: messages enter a PDU queue,
    the streaming TX Block modulates them into a gapless sample stream
    (frames + inter-frame silence), blocks ride the UDP air interface.
    Each batch of PDUs is staged on the device before its push; the loop
    reads the TX carry's pending count between pushes (a host sync there,
    never inside a push)."""
    cfg = ofdm_config(args)
    spec = cfg.spec
    dev = torch.empty(0, device=args.device).device
    link = UdpSampleLink(0, (args.remote_host, args.port))
    msgs = [m.encode() for m in args.message]
    if args.message_file:
        with open(args.message_file) as f:
            msgs = [line.rstrip("\n").encode() for line in f]
    sc = StreamConfig(block_size=args.block_size, max_frames_per_block=4)
    ex = StreamExecutor(tx_stream_block(spec, sc, gap=args.gap), sc.block_size,
                        device=dev)
    pending = list(msgs)
    sent = 0
    k = sc.max_frames_per_block
    try:
        while pending or int(ex.state[1]) > 0:
            ti, _ = queue_tx_in(spec, k, pending, frame_num0=sent, device=dev)
            out = to_host(ex.push(ti))
            acc = out.accepted.numpy()[: min(len(pending), k)]
            n_ok = int(acc.sum())
            # tx_stream places frames in slot order, so accepted is a prefix
            if not acc[:n_ok].all():
                raise RuntimeError(f"accepted slots not a prefix: {acc}")
            for i, a in enumerate(acc):
                if a:
                    print(f"sent frame {sent + i}: {pending[i]!r}",
                          file=sys.stderr)
            sent += n_ok
            pending = ([m for m, a in zip(pending, acc) if not a]
                       + pending[len(acc):])
            link.send(out.samples.numpy())
    finally:
        link.close()
    return 0


def run_listen(args) -> int:
    cfg = ofdm_config(args)
    spec = cfg.spec
    dev = torch.empty(0, device=args.device).device
    link = UdpSampleLink(args.port)
    print(f"listening on udp port {link.port}", file=sys.stderr, flush=True)
    sc = StreamConfig(block_size=args.block_size, max_frames_per_block=8)
    ex = StreamExecutor(rx_stream_block(spec, sc), sc.block_size, device=dev)
    got = 0
    idle = 0.0
    try:
        while (args.messages == 0 or got < args.messages) and idle < args.timeout:
            x = link.receive(sc.block_size, timeout=0.5)
            if x is None:
                idle += 0.5
                continue
            idle = 0.0
            for out in ex.run(x, drain=False):
                for f in collect_frames([to_host(out)]):
                    if f["crc_ok"]:
                        got += 1
                        print(f"[{f['frame_num']}] "
                              f"{f['payload'].decode(errors='replace')}")
    except KeyboardInterrupt:
        pass
    finally:
        link.close()
    print(f"received {got} messages", file=sys.stderr)
    return 0 if got else 1


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="ofdm_chat", description=__doc__)
    sp = p.add_subparsers(dest="mode", required=True)

    s = sp.add_parser("send")
    add_ofdm_args(s)
    add_device_arg(s)
    s.add_argument("--remote-host", default="127.0.0.1")
    s.add_argument("--port", type=int, default=47000)
    s.add_argument("-m", "--message", action="append", default=[])
    s.add_argument("--message-file")
    s.add_argument("--gap", type=int, default=256)
    s.add_argument("--block-size", type=int, default=1 << 12)

    l = sp.add_parser("listen")
    add_ofdm_args(l)
    add_device_arg(l)
    l.add_argument("--port", type=int, default=47000,
                   help="UDP port to bind (0 = any free one)")
    l.add_argument("--block-size", type=int, default=1 << 13)
    l.add_argument("--messages", type=int, default=0,
                   help="stop after N messages (0 = endless)")
    l.add_argument("--timeout", type=float, default=30.0,
                   help="stop after this much idle time")

    args = p.parse_args(argv)
    return run_send(args) if args.mode == "send" else run_listen(args)


if __name__ == "__main__":
    raise SystemExit(main())
