"""Multi-device dry run (counterpart of __graft_entry__.py's
dryrun_multichip): build a balanced_factors(n) (channel x time) mesh and
run the sharded paths once at tiny shapes.

    python -m tpu_ofdm_torch.shard.dryrun N [--device cpu]

The mesh is laid on one device, repeated N times (the card by default), so
the halos, ownership edges and all_to_all of an N-shard mesh run on a
machine with one card.  Checks, raising on a failure: the sharded capture
recovers frames -- one straddling a time-shard ownership boundary --
exactly once with their payloads; the resumable config-5 wideband stream
recovers a frame straddling a chunk boundary once; psum_tree,
all_gather_spectrum and the heartbeat aggregate as they should.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from tpu_ofdm_torch.config import OfdmConfig
from tpu_ofdm_torch.modem.rx_stream import history_len
from tpu_ofdm_torch.modem.tx import tx_frame
from tpu_ofdm_torch.shard import distributed as D
from tpu_ofdm_torch.shard.mesh import balanced_factors, make_mesh
from tpu_ofdm_torch.shard.rx import (collect_sharded_frames,
                                     collect_sharded_stream_frames,
                                     sharded_rx_capture_fn)
from tpu_ofdm_torch.shard.wideband import sharded_wideband_stream_block
from tpu_ofdm_torch.spectrum.channelizer import lowpass_taps, synthesize_bursts
from tpu_ofdm_torch.stream.executor import StreamExecutor


def _check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"dryrun_multichip: {what}")


def dryrun_multichip(n_devices: int, device="cuda") -> str:
    """Run the sharded capture, the config-5 stream and the aggregation
    over an n_devices mesh laid on `device`; returns the summary line."""
    dev = torch.empty(0, device=device).device
    n_channel, n_time = balanced_factors(n_devices)
    mesh = make_mesh(n_channel, n_time, devices=[dev] * n_devices)

    # tiny shapes: short frames, small shard blocks
    spec = OfdmConfig(fft_len=64, cp_len=16, modulation="qpsk",
                      max_payload_bytes=32).spec
    S = 2048
    C = 2 * n_channel          # two channel rows per channel shard
    H = history_len(spec)
    rng = np.random.RandomState(0)
    stream = ((rng.randn(C, n_time * S) + 1j * rng.randn(C, n_time * S))
              * 0.02).astype(np.complex64)

    def frame(payload: bytes, fnum: int) -> np.ndarray:
        buf = torch.zeros(spec.max_payload_bytes - 4, dtype=torch.uint8)
        buf[:len(payload)] = torch.tensor(list(payload), dtype=torch.uint8)
        f = tx_frame(spec, buf, len(payload), fnum)
        return f.samples[:int(f.n_samples)].numpy()

    f0 = frame(b"dryrun frame A", 0)
    own_edge = S - H  # ownership boundary between time shards 0 and 1
    targets = [(0, 300, b"dryrun frame A")]
    if n_time > 1:
        # starts in shard 0's owned window, samples extend into shard 1
        targets.append((C - 1, own_edge - len(f0) // 2, b"dryrun frame B"))
        targets.append((min(1, C - 1), own_edge + 400, b"dryrun frame C"))
    else:
        targets.append((C - 1, 550, b"dryrun frame B"))
    for i, (ch, pos, payload) in enumerate(targets):
        fi = frame(payload, i)
        _check(pos + len(fi) < n_time * S - H, f"target {i} out of range")
        stream[ch, pos:pos + len(fi)] += fi

    res = sharded_rx_capture_fn(spec, mesh, S, max_frames_per_shard=2)(
        torch.as_tensor(stream).to(dev))
    _check(tuple(res.valid.shape) == (C, n_time * 2), "result layout")
    frames = [f for f in collect_sharded_frames(res, S, spec, n_time)
              if f["crc_ok"]]
    got = sorted((f["channel"], f["abs_start"], f["payload"]) for f in frames)
    exp = sorted(targets)
    _check(len(got) == len(exp), f"exactly-once violated: {len(got)} "
           f"recovered vs {len(exp)} injected: {got}")
    for (gc, gs, gp), (ec, es, ep) in zip(got, exp):
        # the Schmidl-Cox plateau centre lands ~cp_len*3/4 = 12 samples
        # past the true frame start
        _check(gc == ec and gp == ep and abs(gs - (es + 12)) <= 4,
               f"frame {(gc, gs, gp)} vs injected {(ec, es, ep)}")
    n_straddle = sum(1 for _, pos, _ in targets
                     if pos < own_edge < pos + len(f0))

    # the resumable config-5 wideband stream: two chunks, one frame
    # straddling the chunk boundary, recovered once from the carries
    n_chan = 2 * n_channel
    Mc = n_time * S
    chunk = n_chan * Mc
    wtaps = lowpass_taps(n_chan, taps_per_arm=8)
    fw = frame(b"dryrun wideband", 3)
    wpos = Mc - len(fw) // 2
    wide = synthesize_bursts(2 * chunk, n_chan, [(1, wpos, fw)], taps=wtaps)
    wide = wide + (rng.randn(2 * chunk) + 1j * rng.randn(2 * chunk)
                   ).astype(np.complex64) * 0.004
    ex = StreamExecutor(sharded_wideband_stream_block(
        spec, mesh, n_chan, S, taps=wtaps, max_frames_per_shard=2),
        chunk, device=dev)
    wide = torch.as_tensor(wide).to(dev)
    outs = [ex.push(wide[k * chunk:(k + 1) * chunk]) for k in range(2)]
    wfr = [f for f in collect_sharded_stream_frames(outs, S, spec, n_time)
           if f["crc_ok"]]
    _check(len(wfr) == 1 and wfr[0]["payload"] == b"dryrun wideband"
           and wfr[0]["channel"] == 1 and abs(wfr[0]["abs_start"] - wpos) < 40,
           f"wideband stream frames {wfr}")

    # aggregation: psum'd link counters, the spectrum consensus, heartbeat
    counters = D.LinkCounters(*(torch.full((n_devices,), float(i + 1),
                                           device=dev) for i in range(6)))
    summary = D.metrics_from_counters(D.psum_tree(counters, mesh))
    _check(summary["frames_detected"] == n_devices, f"psum {summary}")
    psd = torch.as_tensor(np.random.RandomState(1).rand(n_channel, 128)
                          .astype(np.float32)).to(dev)
    g = D.all_gather_spectrum(psd, mesh)
    _check(bool(torch.allclose(g, psd, rtol=1e-5)), "all_gather_spectrum")
    hb = D.MeshHeartbeat(mesh)
    hb.beat(1)
    hb.beat(2)
    _check(hb.stalled == [], "heartbeat")

    return (f"dryrun_multichip OK: mesh {n_channel}x{n_time} (channel x "
            f"time) of {n_devices} shards on {dev}, {C} channels, "
            f"{n_time}x{S} samples, psum/all_gather/heartbeat OK; "
            f"{len(got)}/{len(exp)} frames recovered exactly once (CRC + "
            f"payload verified, {n_straddle} straddling a shard boundary); "
            f"wideband stream {n_chan}ch x 2 chunks: 1/1 chunk-straddling "
            f"frame recovered exactly once")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("n_devices", type=int, nargs="?", default=8)
    ap.add_argument("--device", default="cuda",
                    help="the device every shard is laid on (cuda or cpu)")
    args = ap.parse_args(argv)
    print(dryrun_multichip(args.n_devices, args.device))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
