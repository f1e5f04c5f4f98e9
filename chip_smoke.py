"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, nvcc, and this checkout; it imports no JAX.  Phases,
in order -- any failure raises and the script exits non-zero:

  1. device   require CUDA; print the card's name and power limit
  2. build    compile the port's CUDA kernels from tpu_ofdm_torch/csrc
  3. kernels  each kernel against its plain PyTorch version on the card, at
              the paths' shapes and on golden frames; kernel and plain
              times (warm, with the launches queued ahead so that the
              events time the card); rx_block on the card against rx_block
              on the CPU.  sc_detect by kernel form (launch counts): the
              L = 32 kernel at fft 64, the segment kernel at fft 128, 256,
              512 and 1024 (also at cp 0, batched 4 x [1024 | 32768], and
              timed at BASELINE config 2's [4096 | 2^25]) and the any-L
              kernel at fft 96, each also with its frames ~60 dB over the
              noise; sc_detect and gather also batched over 64 channels;
              gather bit for bit at odd and even F on windows of every
              class and both parities, and timed cold
              (L2 flushed before each launch) and per call from the host
              beside x.unfold(-1, F, 1)[starts]; pfb at 8..512 channels with a
              two-step tail carry, its channel-major form bit for bit
              against the row form transposed at every covered channel
              count (zero and carried tails, and 2^25 at 64 channels), and
              the one-shot channelize on the card against the CPU; psd at
              every covered N (16, 32, 64, 128 n1) with two windows, bin
              by bin, on batched inputs with ragged rows through
              psd_frames (one launch each), and beside
              torch.fft.fft; pfb and psd also at the shapes the paths
              give them; scan also at ragged lengths and along a leading
              axis, beside float32 and float64 torch.cumsum; sc_metric raw
              against its float64 plain version and gated bit for bit
              against the raw form and the torch gate, frames at the
              kernel's strip and halo edges, warm and cold
  4. main     streaming RX through StreamExecutor at block 2^25, K = 480,
              fft 64, cp 16, QPSK: 448 golden frames per block, 24 timed
              pushes x 3 trials; every frame must come back with the
              injected payload and crc_ok, and both kernels must have been
              launched by the main path
  5. wideband channelizer -> 64 parallel demods (BASELINE config 4) at
              block 2^25, K = 4: 3 frames per push on channels 3, 17, 40,
              4 timed pushes x 3 trials; every push must give exactly those
              frames; pfb, sc_detect and gather must have been launched,
              pfb once a push in its channel-major form
  6. spectrum spectrum probe (1024, blackman_harris), logpwrfft (1024,
              alpha 0.1) and waterfall (512 x 32) on 2^22-sample blocks, 3
              pushes each, against the same blocks on the CPU; the tone
              must peak in its bin; psd must have been launched
  7. scan     512-channel power scan on 2^23-sample blocks: the tone
              channels must be the strongest, as on the CPU; pfb must have
              been launched at 512 channels
  8. radio    the full-duplex radio at the headline spec (block 2^25,
              K = 480): 448 PDUs of 1-252 bytes per push, TX -> channel
              (25 dB, CFO 0.05) -> RX one push later, drained with empty
              inputs; every accepted PDU must come back exactly once with
              its payload and crc_ok, hard/pilot_phase over 3 timed trials
              and soft/simpledfe once (LLR signs = the wire bits); one push
              under sync-debug "error"; sc_detect and gather launched
  9. sync     the Schmidl-Cox metric on 4096 captures x 6144 samples of a
              port-TX frame at 3, 10 and 20 dB, CFO 0.2: the fine-CFO
              variance within 0.6-1.8 x the Moose formula; 16 captures card
              vs CPU; the gated sc_metric launched once per schmidl_cox
              call; moving_sum on 2^25 real and complex samples vs float64
              window sums
 10. flowgraph  the graph layer, the examples and the apps: (a) phase 4's
              stream through a one-node grc.build spec, its every-frame
              assert and one sc_detect and one gather launch per push, its
              rate beside phase 4's; (b) examples/*.json loaded by grc --
              psd_probe, decimate_and_measure and channelizer_waterfall
              through run_flowgraph.main on the card and on the CPU
              (outputs bin by bin; psd, pfb launched once a step), the
              loopback example fed PDU batches (every PDU back once); (c) a
              power meter |x|^2 -> moving_average(1024) -> nlog10 on 2^22
              pushes, one scan launch each, against the CPU; (d) the apps:
              ofdm_loopback (64 frames, 25 dB, CFO 0.1, multipath), the
              512-channel power scan (flags exactly the tone channels) and
              the spectrum logger (snapshots as on the CPU); (e) the C1
              routes: psd_frames at N 2048 and 48 and channelize of a
              batched x or at 48 channels compute with no launch and equal
              the CPU, every covered N launches psd; (f) one push of (a)
              and one of the DDC graph under sync-debug "error"
 11. ingest   the headline stream read from a capture file: 6 blocks of
              2^25 (phase 4's layout, frames 2000 samples later, one more
              frame across the seam before block 3) written as i16c;
              FileStreamer (the native runtime, a 2-block ring) ->
              DeviceFeed (2 pinned slots, a copy stream, depth 3) ->
              StreamExecutor under a Watchdog: (b) every frame back with
              payload, crc_ok and start, one sc_detect and one gather a
              push, push 1 under sync-debug "error", ingest rate beside
              phase 4's, each block's host ms of read, convert, feed wait
              and push; a 1-block f32c file through the
              feed equals the staged block bit for bit; (c) save_state
              after 3 blocks, load_state into a fresh executor, resume
              with the first 3 blocks skipped on the host: the same frames,
              the one across the cut once; (d) inject_faults drops block
              4: exactly the frames that touch it are lost; (e) a replay
              gives the same frames and bit-identical output leaves; (f)
              ofdm_chat send -> listen and spectrum_analyzer local ->
              remote on the card over loopback UDP (messages arrive, the
              tone's bin peaks, launches counted), metrics.trace naming
              the port's sc_detect and gather kernels, its host-to-card
              copies of the feed's blocks giving the H2D ms and GB/s
 12. shard    the multi-device layer (tpu_ofdm_torch.shard) on meshes
              that repeat this one card, so one card steps through the
              shards in turn (the per-chunk times are NOT a scaling
              figure): (a) phase 4's stream on a 1x4 mesh (S 2^23, K 120 a
              shard) over 4 staged blocks and a drain: every frame once,
              the frames of rx_stream_block on the same blocks, 4 sc_detect
              and 4 gather launches a push; (b) BASELINE config 5 at 512
              channels (8 taps an arm, 64 B payloads) on a 4x2 mesh, 2^25
              wideband samples a chunk (S 32768, K 4), 4 chunks of frames
              on 32 channels (mid-shard, across the time-shard ownership
              edge and data edge, across the chunk boundary) and a drain:
              every frame once on its channel with payload, crc_ok and a
              start within 40 samples, the frames of a 1x1 mesh and of
              wideband_rx_block(512), a checkpoint after chunk 2 resumed
              exactly, 8 pfb, 8 sc_detect and 8 gather launches a chunk;
              (c) (b)'s first chunk through a world-size-1 NCCL group at
              1x1, every output leaf bit-identical to the local 1x1, and
              psum_tree, all_gather_spectrum, broadcast_control and
              MeshHeartbeat in that group; (d) spectrum_analyzer mesh on a
              2x2 mesh -> remote over loopback UDP: the tone's bin, psd and
              pfb launched once a shard a step; (e) dryrun_multichip(8).
              In (a), (b) and (d) each kernel of the path is also held
              against its plain version, at phase 3's bars, on the inputs
              the second shard gave it (the first with a neighbour's
              halo): sc_detect on [3072 | 2^23] and 128 x [1024 | 32768]
              (config 5's frames ~1e5 over the channel noise: P and R at
              atol 1e-5 times the inputs' scale squared), gather at K 120
              and K 4 x 128, pfb at 512 channels on a 2^22-sample piece
              with its halo, psd at N 32 on a shard's 8 x 32768 rows
              (bin by bin against a float64 PSD) and pfb at 16 channels
 13. configs  BASELINE configs 1-3 (bench/curves.py:49-68, copied here):
              BPSK at fft 64, QPSK at fft 256 / cp 64 with CFO 1.3
              subcarriers, 16-QAM at fft 64 over the taps (1, 0,
              0.35+0.2j, 0, 0.1j) with soft output; each config's golden
              frame impaired once in float64 by the golden channel and laid
              448 to a 2^25 block over the noise.  (a) the streaming RX at
              K 480, 8 timed pushes x 3 trials (phase 4's 24 cut for the
              time limit): every frame back with payload and crc_ok, starts
              in the CP (+ the taps' spread), int_cfo + fine_cfo within
              0.02 of 1.3 at config 2, LLR signs = the wire bits at config
              3; one sc_detect and one gather a push, the L = 32 kernel at
              configs 1 and 3 and the any-L kernel at config 2 (counted by
              form); one push under sync-debug "error"; sc_detect
              (compare_rows and the selection) and gather (bit for bit) on
              the second push's exact inputs, timed beside their plain
              versions, their bounds and x.unfold(-1, F, 1)[starts]; (b)
              rx_block on [H | 2^25] on the card against the CPU: slots,
              payloads, CRC and int_cfo identical, starts within 2, EVM at
              rtol 1e-3, LLRs at atol 1e-4 x their max; (c) the golden RX on
              16 frames: the card's EVM under 2 x golden + 0.02; (d) the
              radio loopback at the config (448 PDUs a push, channel_block
              with its CFO or taps at 25 dB, 30 dB at config 3), every PDU
              back once, phase 8's gate
 14. graphs   rx_block's CUDA graphs (modem/rx.py StepGraphs): after two
              warm-up pushes (eager, then the capture), 6 consecutive
              pushes of phase 4's stream, configs 1-3 (config 3 also with
              simpledfe), config 4's wideband receiver and the radio (hard
              and soft/simpledfe) replay their steps; each step's every
              output bit-identical to rx_block_eager (the function the
              graphs are captured from) on the same inputs, and unchanged
              after the later pushes have been enqueued; the replay share
              (counters rx.graph_replay / rx.graph_eager) must be 100%;
              then phase 4's stream, config 2 and config 4 through their
              sinks, 3 rounds of 3 pushes each collected in one call: every
              dict equal to the eager steps' (read field by field), and
              every step read back after its own event (counter sink.side)
 15. report   one JSON line of per-kernel results (sc_detect and gather
              also per config of phase 13), the nvidia-smi line, and the
              final {"ok": true, ...} line
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import io
import itertools
import json
import math
import pathlib
import re
import subprocess
import sys
import tempfile
import threading
import time
import typing
import zlib

import numpy as np
import torch

# The golden model is loaded by path: an installed third-party package may
# ship a top-level `tests` package that shadows this checkout's tests/.
ROOT = pathlib.Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "tests" / "golden"))
import golden_ofdm as G  # noqa: E402
from tpu_ofdm_torch import grc, runtime
from tpu_ofdm_torch.apps import (ofdm_chat, ofdm_loopback, run_flowgraph,
                                 spectrum_analyzer, spectrum_logger,
                                 wideband_scanner)
from tpu_ofdm_torch.apps.common import add_source_args, make_source
from tpu_ofdm_torch.apps.wideband_scanner import power_scan_block
from tpu_ofdm_torch.config import OfdmConfig, StreamConfig
from tpu_ofdm_torch.io import DeviceFeed, SpectrumSubscriber, file_sink
from tpu_ofdm_torch.kernels import build
from tpu_ofdm_torch.kernels import gather as kgather
from tpu_ofdm_torch.kernels import pfb as kpfb
from tpu_ofdm_torch.kernels import psd as kpsd
from tpu_ofdm_torch.kernels import sc_detect as kdetect
from tpu_ofdm_torch.kernels import sc_metric as kmetric
from tpu_ofdm_torch.kernels import scan as kscan
from tpu_ofdm_torch.modem import rx as mrx
from tpu_ofdm_torch.modem.radio import ofdm_radio
from tpu_ofdm_torch.modem.rx import rx_block
from tpu_ofdm_torch.modem.rx_stream import (collect_frames, history_len,
                                            rx_stream_block)
from tpu_ofdm_torch.modem.wideband import (collect_wideband_frames,
                                           wideband_rx_block)
from tpu_ofdm_torch.modem.tx import tx_frame
from tpu_ofdm_torch.modem.tx_stream import (TxStreamIn, empty_tx_in,
                                            queue_tx_in)
from tpu_ofdm_torch.ops.channel import channel_block
from tpu_ofdm_torch.ops.sync import (_select_from_rows,
                                     coarse_sliding_max_same, moving_sum,
                                     schmidl_cox)
from tpu_ofdm_torch.spectrum import (log_pwr_fft_block, psd_frames,
                                     spectrum_probe_block, waterfall_block)
from tpu_ofdm_torch.spectrum.channelizer import (channelize,
                                                 channelize_stream,
                                                 lowpass_taps,
                                                 polyphase_decompose,
                                                 synthesize_bursts)
from tpu_ofdm_torch.runtime import FileStreamer
from tpu_ofdm_torch.shard import distributed as shard_dist
from tpu_ofdm_torch.shard import (collect_sharded_stream_frames, make_mesh,
                                  sharded_rx_stream_block,
                                  sharded_wideband_stream_block)
from tpu_ofdm_torch.shard.dryrun import dryrun_multichip
from tpu_ofdm_torch.stream.checkpoint import load_state, resume_step, save_state
from tpu_ofdm_torch.stream.executor import StreamExecutor
from tpu_ofdm_torch.utils import metrics
from tpu_ofdm_torch.utils.faults import Watchdog, inject_faults
from tpu_ofdm_torch.utils.metrics import LinkMetrics, PerfCounters

FRAMES_PER_BLOCK = 448
BLOCK = 1 << 25
SLOTS = 480
N_TIMED = 24
MSG = bytes(range(64)) * 2
HEADLINE = OfdmConfig(fft_len=64, cp_len=16, modulation="qpsk")

# BASELINE config 4, the shape of bench/wideband.py
WIDEBAND = OfdmConfig(fft_len=64, cp_len=16, modulation="qpsk",
                      max_payload_bytes=64)
WB_CHANS = 64
WB_SLOTS = 4
WB_PUSHES = 4
WB_MSG = bytes(range(48))
WB_ACTIVE = (3, 17, 40)
WB_OFFSET = 200          # per-channel samples into every block
WB_SLACK = 40            # group delay of the two filterbanks (test_wideband)

PSD_BLOCK = 1 << 22      # bench/kernels.py's PSD size
PSD_TONE_BIN = 100       # of 1024
SCAN_BLOCK = 1 << 23     # bench/kernels.py's channelize_stream512 size
SCAN_CHANS = 512
SCAN_TONES = {11: 1.0, 100: 0.5, 257: 0.25, 500: 0.7}

# each port kernel: its source and the TPU kernels it stands for, by def line
SOURCES = {
    "sc_detect": ("tpu_ofdm_torch/csrc/sc_detect.cu",
                  "tpu_ofdm/kernels/sc_detect.py:299 _sc_detect_pallas, "
                  "tpu_ofdm/kernels/sc_detect.py:349 _sc_detect_pallas_hist"),
    "gather": ("tpu_ofdm_torch/csrc/gather.cu",
               "tpu_ofdm/kernels/gather.py:113 _gather_super, "
               "tpu_ofdm/kernels/gather.py:147 _gather_super2"),
    "pfb": ("tpu_ofdm_torch/csrc/pfb.cu",
            "tpu_ofdm/kernels/pfb.py:136 _pfb_pallas, "
            "tpu_ofdm/kernels/pfb.py:252 _pfb_pallas_wide"),
    "psd": ("tpu_ofdm_torch/csrc/psd.cu",
            "tpu_ofdm/kernels/psd.py:125 _build_call"),
    "scan": ("tpu_ofdm_torch/csrc/scan.cu",
             "tpu_ofdm/kernels/scan.py:82 _cumsum_rows_pallas"),
    "sc_metric": ("tpu_ofdm_torch/csrc/sc_metric.cu",
                  "tpu_ofdm/kernels/sc_metric.py:133 _sc_pallas"),
}
WRAPPERS = {"sc_detect": kdetect.sc_detect_rows,
            "gather": kgather.gather_windows,
            "pfb": kpfb.channelize_fused, "psd": kpsd.psd_fused,
            "scan": kscan.cumsum, "sc_metric": kmetric.sc_sync_metric}

# phase 3: the scan and sc_metric kernels' shapes ((L, shape) for sc_metric;
# a row of BLOCK samples is the headline block with its frames); scan also
# at ragged lengths, whose tiles and rows are not 16-byte aligned
SCAN_SHAPES = [(1, BLOCK), (3, BLOCK), (4096, 6144), (1, BLOCK - 3),
               (1, 6145), (64, 4096 * 3 + 1)]
METRIC_CASES = [(32, (1, BLOCK)), (32, (4096, 6144)), (128, (2, 1 << 20)),
                (192, (2, 1 << 20))]

# phase 8: the radio at the headline spec, bench.py's density
RADIO_PDUS = 448         # per push, of SLOTS = 480 TX slots
RADIO_PUSHES = 4         # pushes that carry PDUs, then RADIO_DRAIN empty ones
RADIO_DRAIN = 2          # one push of air delay + the RX history (3072 < S)
RADIO_SNR, RADIO_CFO = 25.0, 0.05   # tests/test_tx_stream.py:49-50

# phase 9: tests/test_cfo_stats.py's spec and captures, at 4096 trials
SYNC_TRIALS, SYNC_N, SYNC_P0 = 4096, 6144, 1024
SYNC_SNRS = (3.0, 10.0, 20.0)
SYNC_CFO = 0.2


def log(*a):
    print(*a, flush=True)


def today() -> str:
    """The UTC date, printed beside a rate."""
    return time.strftime("%Y-%m-%d", time.gmtime())


def golden_frame(spec, payload=MSG, frame_num=0) -> np.ndarray:
    gp = G.GoldenOfdmParams(fft_len=spec.fft_len, cp_len=spec.cp_len,
                            modulation=spec.modulation)
    return G.tx_frame(gp, payload, frame_num).astype(np.complex64)


def noisy_buffers(n_buf, n, seed, dev) -> torch.Tensor:
    """(n_buf, n) complex64 noise of 0.02 rms per axis, from a seeded CUDA
    generator."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    z = torch.randn((n_buf, n, 2), generator=gen, device=dev) * 0.02
    return torch.view_as_complex(z)


def add_frames(bufs, frame, positions):
    f = torch.as_tensor(frame, device=bufs.device)
    idx = (torch.as_tensor(positions, device=bufs.device)[:, None]
           + torch.arange(len(frame), device=bufs.device))
    bufs[:, idx] += f


# the card's published peaks (H100 SXM): device memory and float32 outside
# the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def bound(nbytes: float, flops: float) -> dict:
    """The least time the card could take for a kernel's work: the larger
    of the bytes it must move (each input read once, each output written
    once) over the memory rate and its float32 operations over the peak
    rate, in ms, and which of the two it is."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOPS_PER_S * 1e3
    return {"bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations"}


def detect_bound(B: int, nv: int) -> dict:
    """sc_detect over B virtual buffers of nv samples: 8 bytes in per
    sample, six float32 summaries out per 128-sample row; ~25 flops per
    sample (|v|^2, the lag product, the window and boxcar sums, M)."""
    rows = -(-nv // kdetect.ROW)
    return bound(B * (8 * nv + 24 * rows), 25 * B * nv)


def window_union(starts, F: int) -> int:
    """Samples covered by the windows [s, s + F): the input a gather must
    read once."""
    s = np.sort(np.asarray(starts, dtype=np.int64).ravel())
    covered = np.minimum(np.diff(s), F).sum() if len(s) > 1 else 0
    return int(covered + (F if len(s) else 0))


def log_bound(what: str, ms: float, b: dict) -> None:
    log(f"  {what}: bound {b['bound_ms']:.4f} ms ({b['bound_by']}), "
        f"{b['bound_ms'] / ms:.3f} of it")


# a spin of ~10 ms on the card (at up to 1.98 GHz) before a timed run
QUEUE_CYCLES = 20_000_000


def cuda_ms(fn, reps: int, queued: bool = True) -> float:
    """Warm: mean ms of `reps` launches in a row, timed by one pair of CUDA
    events; a small input stays in the 50 MB L2 from one launch to the
    next.  `queued`: a spin kernel first holds the stream for QUEUE_CYCLES,
    so the host has queued every launch before the card reaches them, and
    the events time the card alone.  Without it a call shorter on the card
    than on the host is timed at the host's call rate instead."""
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(QUEUE_CYCLES)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


FLUSH_BYTES = 128 << 20  # written before each cold launch: 2.5 x the L2


def cold_ms(fn, reps: int) -> float:
    """Cold: mean ms of `reps` launches, each right after a write of
    FLUSH_BYTES to a scratch buffer and timed by its own pair of CUDA
    events, so that it finds its inputs in device memory, as a path does
    after a pass over its block."""
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32,
                        device=torch.cuda.current_device())
    fn()
    events = [(torch.cuda.Event(enable_timing=True),
               torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    torch.cuda._sleep(QUEUE_CYCLES)
    for t0, t1 in events:
        flush.fill_(1.0)
        t0.record()
        fn()
        t1.record()
    torch.cuda.synchronize()
    return sum(t0.elapsed_time(t1) for t0, t1 in events) / reps


# -- 1. device ---------------------------------------------------------------

def phase_device() -> str:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; "
                         "this script runs only on a CUDA GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(f"device: {torch.cuda.get_device_name(0)}; torch {torch.__version__}"
        f", CUDA {torch.version.cuda}; nvidia-smi: {smi}")
    return smi


# -- 2. build ----------------------------------------------------------------

def phase_build():
    t0 = time.perf_counter()
    lib = build.library()
    log(f"build: {lib.path} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {lib.build_seconds:.2f} s)")
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("  ptxas:", line.strip())


# -- 3. kernels against their plain versions ---------------------------------

def compare_rows(got, ref, what: str, unit: float = 1.0) -> float:
    """Kernel rows vs plain rows: >= 99% identical argmax; the other five
    rows at rtol 1e-4 / atol 1e-5 where the argmax agrees.  Rows 2-5 (P and
    R) are sums of products of two samples: for inputs `unit` times the
    scale of phase 3's (unit 1 there), their atol is 1e-5 * unit^2, the same
    bar at that scale.  Returns the max abs error over the compared
    entries, those of rows 2-5 divided by unit^2 (at phase 3's scale)."""
    same = got[1] == ref[1]
    frac = same.float().mean().item()
    if frac < 0.99:
        raise AssertionError(f"{what}: argmax agrees on {frac:.4f} < 0.99")
    if not torch.equal(torch.isfinite(got[0]), torch.isfinite(ref[0])):
        raise AssertionError(f"{what}: -inf rows differ")
    live = torch.isfinite(ref[0]) & same
    err = 0.0
    for i in (0, 2, 3, 4, 5):
        m = live if i < 5 else torch.ones_like(live)
        a, b = got[i][m], ref[i][m]
        scale = 1.0 if i == 0 else unit ** 2
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5 * scale,
                                   msg=lambda s: f"{what} row {i}: {s}")
        err = max(err, (a - b).abs().max().item() / scale)
    log(f"  {what}: argmax agrees {frac:.5f}, max abs err {err:.3g}"
        + (f" at phase 3's scale (inputs {unit:.4g} times it)"
           if unit != 1.0 else ""))
    return err


TIE_ULPS = 2.0   # check_selection: row maxima this close count as a tie


def check_selection(spec, got, ref, nv, positions, what, slack=0, ties=0):
    """_select_from_rows on kernel rows and on plain rows must give the
    same detections, and find every injected frame inside its CP (+
    `slack`).  `ties`: a selected start may differ from the plain's by up
    to `ties` samples where the two rows' maxima agree to TIE_ULPS float32
    ulps.  The tie-break ramp (1e-7 a sample) lies under float32's
    resolution at sm ~ 1 (1.2e-7), so a flat plateau (cp 256 at fft 1024)
    ties, and a kernel and its plain version, summing in other orders,
    resolve such a tie each its own way."""
    n_sm = nv - spec.fft_len - spec.cp_len + 1
    K = len(positions) + 8
    sel = [_select_from_rows(spec, *rows, n_sm=n_sm, max_frames=K,
                             threshold=spec.cfg.sync_threshold)
           for rows in (got, ref)]
    if not torch.equal(sel[0].valid, sel[1].valid):
        raise AssertionError(f"{what}: selection valid masks differ")
    v = sel[0].valid
    moved = sel[0].start[v] != sel[1].start[v]
    if moved.any():
        gap = (sel[0].start[v] - sel[1].start[v])[moved].abs().max().item()
        a, b = sel[0][3][v][moved], sel[1][3][v][moved]
        ulps = ((a - b).abs() / torch.finfo(torch.float32).eps
                / b.abs().clamp(min=1e-30)).max().item()
        if gap > ties or ulps > TIE_ULPS:
            raise AssertionError(f"{what}: selected starts differ (by up to "
                                 f"{gap} samples, row maxima {ulps:.3g} ulps "
                                 "apart)")
        log(f"  {what}: {int(moved.sum())} of {int(v.sum())} starts on a "
            f"float32 tie, {gap} sample(s) from the plain version's")
    torch.testing.assert_close(sel[0].fine_cfo[v], sel[1].fine_cfo[v],
                               rtol=1e-3, atol=1e-4)
    starts = sel[0].start[v].cpu().numpy()
    want = np.asarray(positions)
    if len(starts) != len(want) or not np.all(
            (starts >= want) & (starts <= want + spec.cp_len + slack)):
        raise AssertionError(f"{what}: found {len(starts)} frames, "
                             f"want {len(want)} inside their CPs")


def check_sc_detect(spec, x, head, positions, what, slack=0, ties=0,
                    select=True) -> float:
    """sc_detect on [head | x] (x (n,) or (B, n), positions then per batch
    row) against its plain version: compare_rows, then (`select`) the
    selection of each batch row by check_selection."""
    L = spec.fft_len // 2
    got = kdetect.sc_detect_rows(x, L, spec.cp_len, head=head)
    ref = kdetect.sc_detect_rows_plain(x, L, spec.cp_len, head=head)
    err = compare_rows(got, ref, what)
    nv = x.shape[-1] + (0 if head is None else head.shape[-1])
    if not select:
        return err
    if x.ndim == 1:
        check_selection(spec, got, ref, nv, positions, what, slack, ties)
    for b in range(x.shape[0] if x.ndim == 2 else 0):
        check_selection(spec, [r[b] for r in got], [r[b] for r in ref], nv,
                        positions[b], f"{what} row {b}", slack, ties)
    return err


# phase 3: sc_detect on 2^20 samples of golden frames, by kernel form
# (kernels.sc_detect.kernel_form): (fft_len, cp, heads, form, ties).  The
# L = 32 and any-L kernels' cases and fft 256 hold the selection exactly;
# at cp >= 128 a start may sit on a float32 tie (check_selection's `ties`)
DETECT_N = 1 << 20
DETECT_CASES = [(64, 16, (0, 3072), "l32", 0),
                (128, 32, (0, 4096), "seg", 0),
                (256, 64, (0, 3072, 4096), "seg", 0),
                (512, 128, (0, 4096), "seg", 2),
                (1024, 256, (0, 4096), "seg", 2),
                (96, 24, (0, 4096), "any_l", 0)]
DETECT_BATCH = (4, 1024, 32768)      # B x [h | n] at fft 256


def detect_form(what: str, form: str, fn):
    """fn() with sc_detect's launch counts by form reset first; it must
    have launched `form` once and no other kernel."""
    reset_launches("sc_detect")
    out = fn()
    got = dict(kdetect.sc_detect_rows.forms)
    want = {f: int(f == form) for f in got}
    if got != want:
        raise AssertionError(f"{what}: sc_detect kernels launched {got}, "
                             f"want {want}")
    return out


def detect_buffer(spec, n: int, seed: int, dev, scale: float = 1.0):
    """n samples of noise (0.02 rms times `scale`) with the golden frame
    of `spec` every n // 24 from 1000; and its positions."""
    frame = golden_frame(spec)
    positions = list(range(1000, n - 2 * len(frame), n // 24))
    buf = noisy_buffers(1, n, seed=seed, dev=dev) * scale
    add_frames(buf, frame, positions)
    return buf[0], positions


def time_detect(x, head, L: int, cp: int, what: str, tag: str) -> dict:
    """The kernel (20 launches) and its plain version (3) on [head | x],
    warm, with the bound and the share."""
    ms = cuda_ms(lambda: kdetect.sc_detect_rows(x, L, cp, head=head), 20)
    plain = cuda_ms(lambda: kdetect.sc_detect_rows_plain(x, L, cp,
                                                         head=head), 3)
    B = x.shape[0] if x.ndim == 2 else 1
    b = detect_bound(B, x.shape[-1] + (0 if head is None else
                                       head.shape[-1]))
    log(f"  {what}: kernel {ms:.4f} ms, plain {plain:.4f} ms  [{tag}]")
    log_bound(what, ms, b)
    return {"ms": ms, "plain_ms": plain, **b, "share": b["bound_ms"] / ms}


def check_detect_forms(dev, tag: str) -> dict:
    """sc_detect's three kernels against the plain version, each case
    counted by form: DETECT_CASES at every head, and with the frames ~60 dB
    over the noise; the segment kernel also at cp 0 (rows only: at cp 0 the
    selection finds extra frames on the plain rows too) and batched, and
    timed at BASELINE config 2's [4096 | 2^25] and on 2^20; the any-L
    kernel timed on 2^20.  Returns {form: times and max error} for the
    segment and any-L kernels."""
    errs = collections.defaultdict(float)
    timed = {}
    for fft_len, cp, heads, form, ties in DETECT_CASES:
        spec = OfdmConfig(fft_len=fft_len, cp_len=cp, modulation="qpsk").spec
        buf, positions = detect_buffer(spec, DETECT_N, fft_len, dev)
        for h in heads:
            head = buf[:h].contiguous() if h else None
            what = f"sc_detect fft {fft_len} cp {cp} head {h} ({form})"
            errs[form] = max(errs[form], detect_form(what, form, lambda: (
                check_sc_detect(spec, buf[h:].contiguous(), head, positions,
                                what, ties=ties))))
        if form != "l32" and fft_len in (96, 256):
            timed[form] = time_detect(buf, None, fft_len // 2, cp,
                                      f"sc_detect ({form}) fft {fft_len} cp "
                                      f"{cp} on 2^20", tag)
        # a quiet channel: the same frames over 5e-4 rms noise, ~60 dB
        # under them, so a window just past a frame is ~1e6 times weaker
        # than the segment before it
        quiet, positions = detect_buffer(spec, DETECT_N, fft_len + 1, dev,
                                         scale=0.025)
        what = (f"sc_detect fft {fft_len} cp {cp} head 3072 ({form}), frames"
                " ~60 dB over the noise")
        errs[form] = max(errs[form], detect_form(what, form, lambda: (
            check_sc_detect(spec, quiet[3072:].contiguous(),
                            quiet[:3072].contiguous(), positions, what,
                            ties=ties))))
    spec = OfdmConfig(fft_len=256, cp_len=0, modulation="qpsk").spec
    buf, positions = detect_buffer(spec, DETECT_N, 257, dev)
    what = "sc_detect fft 256 cp 0 head 4096 (seg), rows"
    errs["seg"] = max(errs["seg"], detect_form(what, "seg", lambda: (
        check_sc_detect(spec, buf[4096:].contiguous(), buf[:4096]
                        .contiguous(), positions, what, select=False))))
    # batched: B buffers [h | n], their frames at other offsets in each
    B, h, n = DETECT_BATCH
    spec = OfdmConfig(fft_len=256, cp_len=64, modulation="qpsk").spec
    frame = golden_frame(spec)
    bufs = noisy_buffers(B, h + n, seed=258, dev=dev)
    rows_pos = []
    for b in range(B):
        pos = list(range(500 + 777 * b, h + n - 2 * len(frame), 5000))
        add_frames(bufs[b:b + 1], frame, pos)
        rows_pos.append(pos)
    what = f"sc_detect fft 256 cp 64 batched {B} x [{h} | {n}] (seg)"
    errs["seg"] = max(errs["seg"], detect_form(what, "seg", lambda: (
        check_sc_detect(spec, bufs[:, h:].contiguous(),
                        bufs[:, :h].contiguous(), rows_pos, what))))
    # full width: BASELINE config 2's [4096 | 2^25] (phase 13's block)
    c2 = BASELINES[1]
    spec = c2.cfg.spec
    H = history_len(spec)
    blocks, pos = staged_blocks(spec, 2, dev, seed=31, frame=baseline_frame(
        c2, baseline_payload(spec, 1)))
    x, head = blocks[0], blocks[1, -H:].contiguous()
    what = f"sc_detect {c2.name} [{H} | 2^25] (seg)"
    errs["seg"] = max(errs["seg"], detect_form(what, "seg", lambda: (
        check_sc_detect(spec, x, head, [p + H for p in pos], what))))
    full = time_detect(x, head, spec.fft_len // 2, spec.cp_len,
                       f"sc_detect (seg) at {c2.name}'s [{H} | 2^25]", tag)
    del blocks, x, head
    return {"seg": {**full, "shape": f"[{H} | 2^25] fft 256 cp 64",
                    "ms_2^20": timed["seg"]["ms"],
                    "plain_ms_2^20": timed["seg"]["plain_ms"],
                    "max_abs_err": errs["seg"]},
            "any_l": {**timed["any_l"], "shape": "2^20 fft 96 cp 24",
                      "max_abs_err": errs["any_l"]}}


def phase_kernels(dev, tag: str) -> list[dict]:
    log("kernels: CUDA kernel vs plain PyTorch version, on the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    forms = check_detect_forms(dev, tag)

    # the headline shape: [3072-sample history | 2^25 block], 448 frames
    spec = HEADLINE.spec
    H = history_len(spec)
    frame = golden_frame(spec)
    blocks, pos = staged_blocks(spec, 2, dev, seed=1)
    head = blocks[1, -H:].contiguous()
    x = blocks[0]
    err_det = check_sc_detect(spec, x, head, [p + H for p in pos],
                              f"sc_detect headline 2^25 + {H}")
    L = spec.fft_len // 2
    ms_det = cuda_ms(lambda: kdetect.sc_detect_rows(x, L, 16, head=head), 20)
    ms_det_plain = cuda_ms(
        lambda: kdetect.sc_detect_rows_plain(x, L, 16, head=head), 3)
    log(f"  sc_detect at 2^25 + {H}: kernel {ms_det:.4f} ms, plain "
        f"{ms_det_plain:.4f} ms  [{tag}]")
    b_det = detect_bound(1, H + BLOCK)
    log_bound(f"sc_detect at 2^25 + {H}", ms_det, b_det)

    # gather: K = 480 windows of F = 2000 across the head/x seam
    F = spec.max_frame_len
    starts = headline_starts(H, F, dev)
    got = kgather.gather_windows(x, starts, F, head=head)
    ref = kgather.gather_windows_plain(x, starts, F, head=head)
    if not torch.equal(got, ref):
        raise AssertionError("gather: kernel differs from plain version")
    log(f"  gather K {SLOTS} F {F} across the seam: exact")
    err_g = max((got - ref).abs().max().item(), check_gather_cases(dev))
    ms_g = cuda_ms(lambda: kgather.gather_windows(x, starts, F, head=head),
                   50)
    call_g = cuda_ms(lambda: kgather.gather_windows(x, starts, F, head=head),
                     50, queued=False)
    cold_g = cold_ms(lambda: kgather.gather_windows(x, starts, F, head=head),
                     GATHER_COLD_REPS)
    ms_g_plain = cuda_ms(
        lambda: kgather.gather_windows_plain(x, starts, F, head=head), 10)
    log(f"  gather K {SLOTS} F {F}: kernel {ms_g:.4f} ms warm, "
        f"{cold_g:.4f} ms cold, {call_g:.4f} ms a call from the host; plain "
        f"{ms_g_plain:.4f} ms  [{tag}]")
    b_g = bound(8 * window_union(starts.cpu().numpy(), F) + 4 * SLOTS
                + 8 * SLOTS * F, 0)
    log_bound(f"gather K {SLOTS} F {F}", ms_g, b_g)
    lib_g = gather_library(x, F, dev, tag)

    # the whole rx_block on the card against the CPU (plain versions)
    small = noisy_buffers(1, 1 << 16, seed=7, dev=dev)
    sp = [300, 9000, 30000, 50001]
    add_frames(small, frame, sp)
    n_ = torch.arange(1 << 16, device=dev, dtype=torch.float32)
    small = (small[0] * torch.exp(2j * torch.pi * 0.21 * n_ / 64)).to(
        torch.complex64)
    hs = small[:H].contiguous()
    xs = small[H:].contiguous()
    on_card = rx_block(spec, xs, 8, head=hs)
    on_cpu = rx_block(spec, xs.cpu(), 8, head=hs.cpu())
    v = on_cpu.valid
    if not torch.equal(on_card.valid.cpu(), v) or int(v.sum()) != len(sp):
        raise AssertionError("rx_block: card and CPU disagree on valid slots")
    if not (torch.equal(on_card.frames.payload.cpu()[v],
                        on_cpu.frames.payload[v])
            and bool(on_card.frames.crc_ok.cpu()[v].all())
            and (on_card.starts.cpu()[v] - on_cpu.starts[v]).abs().max() <= 2):
        raise AssertionError("rx_block: card and CPU disagree on frames")
    log(f"  rx_block card vs CPU on 2^16 samples: {len(sp)} frames agree")

    err_b_det, err_b_g = check_batched(dev, tag)
    kernels = {
        "sc_detect": {"max_abs_err": max([err_det, err_b_det] + [
                          f["max_abs_err"] for f in forms.values()]),
                      "ms": ms_det, "plain_ms": ms_det_plain, **b_det,
                      "library_ms": None,
                      "forms": {"l32": {"ms": ms_det, "plain_ms": ms_det_plain,
                                        **b_det, "share": b_det["bound_ms"]
                                        / ms_det, "max_abs_err": err_det,
                                        "shape": f"[{H} | 2^25]"},
                                **forms}},
        "gather": {"max_abs_err": max(err_g, err_b_g),
                   "ms": ms_g, "plain_ms": ms_g_plain, **b_g,
                   "cold_ms": cold_g, "call_ms": call_g, **lib_g},
        "pfb": check_pfb(dev, tag),
        "psd": check_psd(dev, tag),
        "scan": check_scan(dev, tag),
        "sc_metric": check_sc_metric(dev, tag),
    }
    return kernels


GATHER_COLD_REPS = 24


def headline_starts(H: int, F: int, dev) -> torch.Tensor:
    """gather's starts at the headline shape: K = SLOTS windows of F over
    [H | BLOCK], ten of them at and across the head/x seam and the ends,
    the rest at random."""
    nv = H + BLOCK
    seam = [0, 1, H - F - 1, H - F, H - 1000, H - 1, H, H + 1, nv - F - 1,
            nv - F]
    rng = np.random.RandomState(3)
    rand = rng.randint(0, nv - F + 1, SLOTS - len(seam))
    return torch.as_tensor(np.sort(np.concatenate([seam, rand])),
                           dtype=torch.int32, device=dev)


def gather_library(x, F: int, dev, tag: str) -> dict:
    """The one-call yardstick of gather: x.unfold(-1, F, 1)[starts] on the
    2^25 block alone (no head), K = SLOTS windows.  It must equal the
    kernel; returns its warm, cold and per-call times (the kernel's on the
    same windows are printed beside them)."""
    rng = np.random.RandomState(5)
    starts = torch.as_tensor(np.sort(rng.randint(0, BLOCK - F + 1, SLOTS)),
                             dtype=torch.int32, device=dev)
    idx = starts.long()
    got = kgather.gather_windows(x, starts, F)
    want = x.unfold(-1, F, 1)[idx]
    if not torch.equal(got, want):
        raise AssertionError("gather: kernel differs from x.unfold(...)"
                             "[starts]")
    ms = cuda_ms(lambda: kgather.gather_windows(x, starts, F), 50)
    ms_lib = cuda_ms(lambda: x.unfold(-1, F, 1)[idx], 50)
    cold = cold_ms(lambda: kgather.gather_windows(x, starts, F),
                   GATHER_COLD_REPS)
    cold_lib = cold_ms(lambda: x.unfold(-1, F, 1)[idx], GATHER_COLD_REPS)
    call = cuda_ms(lambda: kgather.gather_windows(x, starts, F), 50,
                   queued=False)
    call_lib = cuda_ms(lambda: x.unfold(-1, F, 1)[idx], 50, queued=False)
    log(f"  gather K {SLOTS} F {F} without head: kernel {ms:.4f} ms warm, "
        f"{cold:.4f} ms cold, {call:.4f} ms a call; x.unfold(-1, F, 1)"
        f"[starts] {ms_lib:.4f} ms warm, {cold_lib:.4f} ms cold, "
        f"{call_lib:.4f} ms a call; equal  [{tag}]")
    return {"library_ms": ms_lib, "library_cold_ms": cold_lib,
            "library_call_ms": call_lib}


def check_gather_cases(dev) -> float:
    """gather against its plain version, bit for bit, on 3 buffers of
    [3072 | 2^16 + 3] samples (an odd row length, so rows and windows start
    at both parities) at F 2000, 1999, 720 and 1: windows wholly in the
    head, ending exactly at the seam, straddling it, starting at x[0], in x
    at both parities, before 0, and running past the end; batched with and
    without the head, and one row alone.  Returns the max abs error."""
    H, n, B = 3072, (1 << 16) + 3, 3
    v = noisy_buffers(B, H + n, seed=13, dev=dev)
    head, x = v[:, :H].contiguous(), v[:, H:].contiguous()
    nv = H + n
    err = 0.0
    for F in (2000, 1999, 720, 1):
        starts = [0, 1, 7, H - F - 1, H - F, H - F + 1, H - F // 2, H - 1, H,
                  H + 1, H + 2, nv // 2, nv // 2 + 1, nv - F - 1, nv - F,
                  nv - F + 1, nv - 1, nv, nv + 5, -1, -F, -F - 3, -(F // 2)]
        st = torch.tensor(starts, dtype=torch.int32, device=dev)
        st = torch.stack([st.roll(b) for b in range(B)])   # (B, K)
        cases = [(x, st, head, "batched"), (x, st, None, "batched, no head"),
                 (x[1].contiguous(), st[1].contiguous(),
                  head[1].contiguous(), "row 1")]
        for xs, ss, hs, what in cases:
            got = kgather.gather_windows(xs, ss, F, head=hs)
            want = kgather.gather_windows_plain(xs, ss, F, head=hs)
            if not torch.equal(got, want):
                raise AssertionError(f"gather F {F} {what}: kernel differs "
                                     "from the plain version")
            err = max(err, (got - want).abs().max().item())
    log(f"  gather at F 2000, 1999, 720, 1 over {B} x [{H} | 2^16 + 3], "
        "every window class, both parities: exact")
    return err


def check_batched(dev, tag: str) -> tuple[float, float]:
    """sc_detect and gather over 64 channels of [3072 history | 2^19]
    samples, each channel with its own frames: kernel rows and selections
    equal the plain version's, and every frame is found."""
    spec = WIDEBAND.spec
    H = history_len(spec)
    n = BLOCK // WB_CHANS
    frame = golden_frame(spec, WB_MSG)
    bufs = noisy_buffers(WB_CHANS, H + n, seed=11, dev=dev)
    rng = np.random.RandomState(4)
    gap = (H + n - 2 * len(frame)) // 3
    positions = [sorted(rng.randint(0, gap - len(frame), 3)
                        + np.arange(3) * gap + 100) for _ in range(WB_CHANS)]
    f = torch.as_tensor(frame, device=dev)
    for c, ps in enumerate(positions):
        for p in ps:
            bufs[c, p:p + len(frame)] += f
    head = bufs[:, :H].contiguous()
    x = bufs[:, H:].contiguous()
    L = spec.fft_len // 2
    what = f"sc_detect batched {WB_CHANS} x ({H} + 2^19)"
    got = kdetect.sc_detect_rows(x, L, spec.cp_len, head=head)
    ref = kdetect.sc_detect_rows_plain(x, L, spec.cp_len, head=head)
    err = compare_rows(got, ref, what)
    n_sm = H + n - spec.fft_len - spec.cp_len + 1
    K = 8
    sel = [_select_from_rows(spec, *rows, n_sm=n_sm, max_frames=K,
                             threshold=spec.cfg.sync_threshold)
           for rows in (got, ref)]
    if not (torch.equal(sel[0].valid, sel[1].valid)
            and torch.equal(sel[0].start, sel[1].start)):
        raise AssertionError(f"{what}: selections differ")
    for c, ps in enumerate(positions):
        st = sel[0].start[c][sel[0].valid[c]].cpu().numpy()
        want = np.asarray(ps)
        if len(st) != len(want) or not np.all((st >= want)
                                              & (st <= want + spec.cp_len)):
            raise AssertionError(f"{what}: channel {c} found {st}, want {ps}")
    log(f"  {what}: selections identical, all {3 * WB_CHANS} frames found")
    ms = cuda_ms(lambda: kdetect.sc_detect_rows(x, L, spec.cp_len,
                                                head=head), 20)
    ms_plain = cuda_ms(lambda: kdetect.sc_detect_rows_plain(
        x, L, spec.cp_len, head=head), 3)
    log(f"  {what}: kernel {ms:.4f} ms, plain {ms_plain:.4f} ms  [{tag}]")
    log_bound(what, ms, detect_bound(WB_CHANS, H + n))

    F = spec.max_frame_len
    starts = sel[0].start.clamp(0, H + n - F).contiguous()
    starts[:, -1] = torch.as_tensor([0, H - 1, H - F // 2, H + n - F] * 16,
                                    dtype=torch.int32, device=dev)
    gw = kgather.gather_windows(x, starts, F, head=head)
    gw_ref = kgather.gather_windows_plain(x, starts, F, head=head)
    if not torch.equal(gw, gw_ref):
        raise AssertionError("gather batched: kernel differs from plain")
    ms_g = cuda_ms(lambda: kgather.gather_windows(x, starts, F, head=head),
                   50)
    ms_g_plain = cuda_ms(lambda: kgather.gather_windows_plain(
        x, starts, F, head=head), 10)
    log(f"  gather batched {WB_CHANS} x K {K} F {F}: exact; kernel "
        f"{ms_g:.4f} ms, plain {ms_g_plain:.4f} ms  [{tag}]")
    return err, (gw - gw_ref).abs().max().item()


def check_close(got, want, bar: float, what: str) -> float:
    """max |got - want| <= bar * max|want|; returns the max abs error."""
    e = (got - want).abs().max().item()
    b = bar * want.abs().max().item()
    if not e <= b:
        raise AssertionError(f"{what}: max abs err {e:.3g} > {b:.3g}")
    log(f"  {what}: max abs err {e:.3g} (bar {b:.3g})")
    return e


def power_ratio(got, want, floor: float | None = None):
    """(the worst bin's |got - want| / (1e-4 * (want + floor)), floor):
    floor is the median of `want` (its noise floor per bin) unless
    given."""
    got, want = got.double(), want.double()
    floor = want.median().item() if floor is None else floor
    err = (got - want).abs()
    return (err / (1e-4 * (want.abs() + floor))).max().item(), floor


def check_power(got, want, what: str, floor: float | None = None) -> float:
    """Linear power, bin by bin: |got - want| <= 1e-4 * (want + floor),
    floor as power_ratio takes it.  Every bin is held to its own size, not
    to the strongest one's: a wrong or empty bin among the noise fails.
    Returns the max abs error."""
    ratio, floor = power_ratio(got, want, floor)
    if not ratio <= 1.0:
        raise AssertionError(f"{what}: a bin is off by {ratio:.3g} x its "
                             f"bar 1e-4 * (power + {floor:.3g})")
    e = (got.double() - want.double()).abs().max().item()
    log(f"  {what}: max abs err {e:.3g}, worst bin at {ratio:.3g} of its "
        f"bar (floor {floor:.3g})")
    return e


def check_pfb(dev, tag: str) -> dict:
    """pfb against its plain version at 8..512 channels over 2^20 samples,
    in two steps joined by the tail carry, and at the paths' shapes, on
    noise alone (atol 2e-4 * max|want|, the bar of
    tests/test_kernels_pfb.py); its channel-major form equal to the row
    form transposed (check_pfb_chan); then kernel (both forms) and plain
    times at the paths' shapes."""
    err = 0.0
    for N in (8, 64, 128, 384, 512):
        poly = torch.as_tensor(polyphase_decompose(lowpass_taps(N), N),
                               device=dev)
        C = kpfb.tail_len(N, poly.shape[0])
        rows = (1 << 20) // N
        x = noisy_buffers(1, rows * N, seed=N, dev=dev)[0]
        n0 = (rows // 2) * N
        want = kpfb.channelize_fused_plain(x, poly)
        a = kpfb.channelize_fused(x[:n0], poly, tail=x.new_zeros(C))
        b = kpfb.channelize_fused(x[n0:], poly, tail=x[n0 - C:n0])
        err = max(err, check_close(
            torch.cat([a, b]), want, 2e-4,
            f"pfb N {N} over 2^20 in two carried steps"))
    check_pfb_chan(dev)
    err = max(err, check_channelize(dev))
    times, bounds = {}, {}
    for N, n in ((WB_CHANS, BLOCK), (SCAN_CHANS, SCAN_BLOCK)):
        poly = torch.as_tensor(polyphase_decompose(lowpass_taps(N), N),
                               device=dev)
        x = noisy_buffers(1, n, seed=3, dev=dev)[0]
        tail = x[-kpfb.tail_len(N, poly.shape[0]):].clone()
        err = max(err, check_close(
            kpfb.channelize_fused(x, poly, tail),
            kpfb.channelize_fused_plain(x, poly, tail), 2e-4,
            f"pfb N {N} at {n} samples"))
        times[N] = (
            cuda_ms(lambda: kpfb.channelize_fused(x, poly, tail), 20),
            cuda_ms(lambda: kpfb.channelize_fused_plain(x, poly, tail), 3),
            cuda_ms(lambda: kpfb.channelize_fused(x, poly, tail,
                                                  layout="chan"), 20))
        log(f"  pfb N {N} at {n} samples: kernel {times[N][0]:.4f} ms, "
            f"plain {times[N][1]:.4f} ms, channel-major {times[N][2]:.4f} "
            f"ms  [{tag}]")
        J = poly.shape[0]
        # x in and out, the FIR's lookback in the tail, the taps; a complex
        # times real multiply-add per tap, ~5 log2 N flops of FFT
        bounds[N] = bound(16 * n + 8 * (J - 1) * N + 4 * J * N,
                          n * (4 * J + 5 * math.log2(N)))
        log_bound(f"pfb N {N} at {n} samples", times[N][0], bounds[N])
        log_bound(f"pfb N {N} at {n} samples, channel-major", times[N][2],
                  bounds[N])
    return {"max_abs_err": err, "ms": times[WB_CHANS][0],
            "plain_ms": times[WB_CHANS][1], "chan_ms": times[WB_CHANS][2],
            **bounds[WB_CHANS], "library_ms": None}


def check_pfb_chan(dev) -> None:
    """pfb's channel-major form (layout "chan") against the row form's
    output transposed, bit for bit (torch.equal): at every channel count
    the kernel covers over 2^20 samples, in two steps, the first from a
    zero tail and the second carrying the first's, and at 2^25 samples at
    64 channels (the wideband step's shape) with a noise tail."""
    cases = [(N, (1 << 20) // N * N, False) for N in range(1, 513)
             if kpfb.supported(N)]
    for N, n, whole in cases + [(WB_CHANS, BLOCK, True)]:
        poly = torch.as_tensor(polyphase_decompose(lowpass_taps(N), N),
                               device=dev)
        C = kpfb.tail_len(N, poly.shape[0])
        x = noisy_buffers(1, n, seed=N + 40, dev=dev)[0]
        if whole:
            steps = [(x, noisy_buffers(1, C, seed=41, dev=dev)[0])]
        else:
            n0 = n // 2 // N * N
            steps = [(x[:n0], None), (x[n0:], x[n0 - C:n0])]
        for xs, tail in steps:
            row = kpfb.channelize_fused(xs, poly, tail)
            chan = kpfb.channelize_fused(xs, poly, tail, layout="chan")
            if not torch.equal(chan, row.t().contiguous()):
                bad = (chan != row.t()).sum().item()
                raise AssertionError(
                    f"pfb N {N}, {xs.shape[0]} samples, tail "
                    f"{'none' if tail is None else tail.shape[0]}: the "
                    f"channel-major form differs from the row form "
                    f"transposed at {bad} samples")
    log(f"  pfb channel-major form equal to the row form transposed at "
        f"{len(cases)} channel counts over 2^20 (zero and carried tails) "
        f"and at {WB_CHANS} over 2^{BLOCK.bit_length() - 1}")


def check_channelize(dev) -> float:
    """The one-shot channelize on the card (pfb with a zero tail, launched
    once) against channelize on the CPU at pfb's bar, at 64 and 512
    channels.  Returns the max abs error."""
    err = 0.0
    for N in (WB_CHANS, SCAN_CHANS):
        taps = lowpass_taps(N)
        x = noisy_buffers(1, (1 << 18) + 5, seed=26, dev=dev)[0]
        before = kpfb.channelize_fused.launches
        got = channelize(x, N, taps)
        if kpfb.channelize_fused.launches != before + 1:
            raise AssertionError("channelize on the card did not launch pfb")
        err = max(err, check_close(got.cpu(), channelize(x.cpu(), N, taps),
                                   2e-4, f"channelize N {N}, card vs CPU"))
    return err


def check_psd(dev, tag: str) -> dict:
    """psd against its plain version on noise alone at every covered N
    (16, 32, 64 and 128 n1, n1 = 1..8) with two windows, at the spectrum
    path's shapes, and on batched inputs with ragged rows ((3, 5 N + 7) and
    the wideband PSD's (64, 2^19) at N 64): within 1e-4 * max (the bar of
    tests/test_kernels_psd.py), and bin by bin (check_power).
    spectrum.psd_frames must launch the kernel once on each batched input.
    Then kernel (warm and cold),
    plain and torch.fft.fft times at the paths' shapes."""
    err = 0.0
    x = noisy_buffers(1, 1 << 20, seed=21, dev=dev)[0]
    cases = [(x, "2^20", N, window) for N in kpsd.COVERED
             for window in ("hann", "blackman_harris")]
    xp = noisy_buffers(1, PSD_BLOCK, seed=22, dev=dev)[0]
    cases += [(xp, "2^22", 1024, "blackman_harris"),
              (xp, "2^22", 1024, "hann"), (xp, "2^22", 512, "hann")]
    for xs, size, N, window in cases:
        got = kpsd.psd_fused(xs, N, window)
        want = kpsd.psd_fused_plain(xs, N, window)
        what = f"psd N {N} {window} over {size}"
        err = max(err, check_close(got, want, 1e-4, what),
                  check_power(got, want, what))
    rows64 = noisy_buffers(WB_CHANS, BLOCK // WB_CHANS, seed=23, dev=dev)
    for xs, N in ((noisy_buffers(3, 5 * 64 + 7, seed=24, dev=dev), 64),
                  (noisy_buffers(3, 5 * 384 + 7, seed=25, dev=dev), 384),
                  (rows64, 64)):
        before = kpsd.psd_fused.launches
        got = psd_frames(xs, N, "hann")
        want = kpsd.psd_fused_plain(xs, N, "hann")
        what = f"psd_frames N {N} over {tuple(xs.shape)}"
        if kpsd.psd_fused.launches != before + 1 or got.shape != want.shape:
            raise AssertionError(f"{what}: {kpsd.psd_fused.launches - before}"
                                 f" launches, shape {tuple(got.shape)}")
        err = max(err, check_close(got, want, 1e-4, what),
                  check_power(got, want, what))
    ms = cuda_ms(lambda: kpsd.psd_fused(xp, 1024), 50)
    cold = cold_ms(lambda: kpsd.psd_fused(xp, 1024), GATHER_COLD_REPS)
    plain = cuda_ms(lambda: kpsd.psd_fused_plain(xp, 1024), 10)
    frames = xp.view(-1, 1024)
    fft_only = cuda_ms(lambda: torch.fft.fft(frames), 50)
    ms512 = cuda_ms(lambda: kpsd.psd_fused(xp, 512), 50)
    ms64 = cuda_ms(lambda: kpsd.psd_fused(rows64, 64), 20)
    cold64 = cold_ms(lambda: kpsd.psd_fused(rows64, 64), GATHER_COLD_REPS)
    log(f"  psd N 1024 at 2^22 samples: kernel {ms:.4f} ms warm, {cold:.4f} "
        f"cold; plain {plain:.4f}; torch.fft.fft alone on the (4096, 1024) "
        f"frames {fft_only:.4f}; N 512 {ms512:.4f}; N 64 on (64, 2^19) "
        f"{ms64:.4f} warm, {cold64:.4f} cold  [{tag}]")
    # 8 bytes in and 4 out per sample, the window; window product, FFT and
    # |.|^2 flops
    b = bound(12 * PSD_BLOCK + 4 * 1024, PSD_BLOCK * (5 + 5 * 10))
    log_bound("psd N 1024 at 2^22 samples", ms, b)
    b64 = bound(12 * BLOCK + 4 * 64, BLOCK * (5 + 5 * 6))
    log_bound("psd N 64 on (64, 2^19)", ms64, b64)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain, **b,
            "library_ms": None, "cold_ms": cold, "fft_only_ms": fft_only,
            "rows64_ms": ms64, "rows64_cold_ms": cold64,
            "rows64_bound_ms": b64["bound_ms"]}


def scan_ratio(got, x, axis: int = -1) -> tuple[float, float]:
    """(max abs error, worst ratio to scan's bar) of a float32 prefix `got`
    of x along `axis` against the plain version.  Both sides round a
    float64 sum to float32 once, so the bar is one float32 ulp plus the
    float64 sums' own difference: 2^-23 |want| + 1e-10 * sum_{i<=t} |x_i|
    at every t."""
    want = kscan.cumsum_plain(x, axis).double()
    bar = (2.0 ** -23 * want.abs()
           + 1e-10 * torch.cumsum(x.abs().double(), dim=axis))
    d = (got.double() - want).abs()
    return d.max().item(), (d / bar).max().item()


def check_scan(dev, tag: str) -> dict:
    """cumsum against its float64 plain version at (1, 2^25), (3, 2^25)
    (the moving_sums shape), (4096, 6144) and the ragged SCAN_SHAPES, on
    Gaussian samples of mean 0.25, so the prefix drifts, at scan_ratio's
    bar (the worst ratio is printed); along a leading axis too, where the
    kernel must launch once per call.  Then kernel and plain times; the
    kernels line takes (1, 2^25), since torch's float64 cumsum slows far
    more than 3x on three such rows.  Whether two runs at (1, 2^25) gave
    the same bits is printed: the look-back may add the float64 terms in
    another order (csrc/scan.cu), so it is no gate."""
    err = 0.0
    times = {}
    for i, shape in enumerate(SCAN_SHAPES):
        gen = torch.Generator(device=dev).manual_seed(80 + i)
        x = torch.randn(shape, generator=gen, device=dev) + 0.25
        got = kscan.cumsum(x)
        e, ratio = scan_ratio(got, x)
        if not ratio <= 1.0:
            raise AssertionError(f"scan {shape}: worst t at {ratio:.3g} of "
                                 "its bar 2^-23 |want| + 1e-10 sum |x_i|")
        err = max(err, e)
        if i == 0:
            same = torch.equal(got, kscan.cumsum(x))
            log(f"  scan {shape}: two runs bit-identical: {same}")
        times[shape] = (cuda_ms(lambda: kscan.cumsum(x), 20),
                        cuda_ms(lambda: kscan.cumsum_plain(x), 5))
        log(f"  scan {shape}: max abs err {e:.3g}, worst t at {ratio:.3g} of "
            f"its bar; kernel {times[shape][0]:.4f} ms, plain "
            f"{times[shape][1]:.4f} ms  [{tag}]")
    gen = torch.Generator(device=dev).manual_seed(89)
    for shape, axis in (((4096, 640), 0), ((8, 3001, 5), 1)):
        x = torch.randn(shape, generator=gen, device=dev) + 0.25
        before = kscan.cumsum.launches
        got = kscan.cumsum(x, axis=axis)
        e, ratio = scan_ratio(got, x, axis)
        if kscan.cumsum.launches != before + 1 or not ratio <= 1.0:
            raise AssertionError(f"scan {shape} axis {axis}: "
                                 f"{kscan.cumsum.launches - before} launches,"
                                 f" worst t at {ratio:.3g} of its bar")
        err = max(err, e)
        log(f"  scan {shape} along axis {axis}: one launch, max abs err "
            f"{e:.3g}, worst t at {ratio:.3g} of its bar")
    ms, plain_ms = times[SCAN_SHAPES[0]]
    n = math.prod(SCAN_SHAPES[0])
    b = bound(8 * n, n)
    log_bound(f"scan {SCAN_SHAPES[0]}", ms, b)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **b,
            **scan_library(dev, tag)}


def scan_library(dev, tag: str) -> dict:
    """The one-call yardsticks of scan at SCAN_SHAPES[0]: torch.cumsum in
    float32 (`library_ms`), held to scan's bar (the worst ratio is printed;
    it is no gate, as float32 cumsum is not meant to meet it), and in
    float64 (`library_f64_ms`), the one call that meets the bar."""
    gen = torch.Generator(device=dev).manual_seed(80)
    x = torch.randn(SCAN_SHAPES[0], generator=gen, device=dev) + 0.25
    _, ratio = scan_ratio(torch.cumsum(x, -1), x)
    ms = cuda_ms(lambda: torch.cumsum(x, -1), 20)
    ms64 = cuda_ms(lambda: torch.cumsum(x, -1, dtype=torch.float64), 5)
    log(f"  scan {SCAN_SHAPES[0]}: torch.cumsum float32 {ms:.4f} ms, worst "
        f"t at {ratio:.3g} of scan's bar; float64 {ms64:.4f} ms  [{tag}]")
    return {"library_ms": ms, "library_f64_ms": ms64}


def pair_energy(r, L: int) -> torch.Tensor:
    """E[d] = sum_{q<2L} |r[d+q]|^2 = R1 + R2 of the window pair at d,
    float64, length n - 2L + 1."""
    c = torch.cumsum(r.abs().double() ** 2, -1)
    W = c[..., L - 1:] - torch.cat([c.new_zeros((*c.shape[:-1], 1)),
                                    c[..., :-L]], -1)  # sum_{q<L} |r[j+q]|^2
    return W[..., :-L] + W[..., L:]


def metric_captures(B: int, n: int, L: int, dev) -> torch.Tensor:
    """(B, n) complex64 noise with golden frames at the edges of the sc_metric
    kernel's tiles (warp strips of 4096 outputs) and of their gate halos
    (+-256 outputs), or, in rows too short for that, across the row."""
    frame = golden_frame(HEADLINE.spec)
    r = noisy_buffers(B, n, seed=L + B, dev=dev)
    if n >= 1 << 16:
        pos = [p for k in (3, 50, 200) for p in (4096 * k - len(frame) - 40,
                                                 4096 * k + 10,
                                                 4096 * k + 2200)]
    else:
        pos = list(range(1024, n - len(frame), max(n // 8, len(frame) + 7)))
    add_frames(r, frame, pos)
    return r


def metric_ratios(r, L: int, got) -> dict:
    """Worst ratios of sc_metric's raw (P, R, M) to its bars against the
    float64 plain version, relative to the window pair's energy E = R1 + R2
    (|P| <= E / 2): |dP|, |dR| <= 1e-5 E, and |dM| <= 1e-4 (E/R)(E/R + 2M),
    what those bars allow M with a 10x margin."""
    P, R, M = got
    Pw, Rw, Mw = kmetric.sc_sliding_metric_plain(r, L)
    E = pair_energy(r, L)
    q = E / Rw.double()
    bars = {"P": (P - Pw).abs().double() / (1e-5 * E),
            "R": (R - Rw).abs().double() / (1e-5 * E),
            "M": (M - Mw).abs().double() / (1e-4 * q * (q + 2 * Mw))}
    return {k: v.max().item() for k, v in bars.items()}


def metric_gate_width(L: int) -> int:
    """schmidl_cox's gate width, 2 sym_len + 1, for fft 2L, cp fft / 4."""
    return 2 * (2 * L + L // 2) + 1


def check_sc_metric(dev, tag: str) -> dict:
    """sc_sliding_metric (raw) against its float64 plain version at L 32 on
    the headline block (448 golden frames over noise, 2^25) and on (4096,
    6144) captures, and at L 128 and 192 on (2, 2^20) with frames at the
    tile and halo edges, at metric_ratios' bars; the gated form
    (sc_sync_metric, schmidl_cox's) against the raw form followed by the
    torch cap and gate, on the same input on the card: P, R and M bit for
    bit.  Then raw and gated times, warm and cold, and the plain time."""
    err = 0.0
    times = {}
    spec = HEADLINE.spec
    for L, shape in METRIC_CASES:
        if shape[1] == BLOCK:
            r = staged_blocks(spec, 1, dev, seed=5)[0][None]
        else:
            r = metric_captures(shape[0], shape[1], L, dev)
        P, R, M = kmetric.sc_sliding_metric(r, L)
        worst = metric_ratios(r, L, (P, R, M))
        if not all(w <= 1.0 for w in worst.values()):
            raise AssertionError(f"sc_metric L {L} {shape}: worst ratios to "
                                 f"the bars {worst}")
        Pw, Rw, Mw = kmetric.sc_sliding_metric_plain(r, L)
        e = max((P - Pw).abs().max().item(), (R - Rw).abs().max().item(),
                (M - Mw).abs().max().item())
        err = max(err, e)
        del Pw, Rw, Mw
        w = metric_gate_width(L)
        Pg, Rg, Mg = kmetric.sc_sync_metric(r, L, w)
        Mc = kmetric.gate_metric(M, R, w)
        if not (torch.equal(Pg, P) and torch.equal(Rg, R)
                and torch.equal(Mg, Mc)):
            raise AssertionError(f"sc_metric L {L} {shape}: the gated form "
                                 "differs from the raw form and the torch "
                                 "gate")
        gated = f"gated form exact, {int((Mg > 0).sum())} M > 0"
        del P, R, M, Pg, Rg, Mg, Mc
        t = ""
        if L == 32:
            raw = lambda: kmetric.sc_sliding_metric(r, L)      # noqa: E731
            gate = lambda: kmetric.sc_sync_metric(r, L, w)     # noqa: E731
            times[shape] = {
                "ms": cuda_ms(raw, 20), "cold_ms": cold_ms(raw, 10),
                "gated_ms": cuda_ms(gate, 20),
                "gated_cold_ms": cold_ms(gate, 10),
                "plain_ms": cuda_ms(
                    lambda: kmetric.sc_sliding_metric_plain(r, L), 3)}
            t = "; " + ", ".join(f"{k} {v:.4f}"
                                 for k, v in times[shape].items())
        log(f"  sc_metric L {L} {shape}: max abs err {e:.3g}, worst ratio "
            f"to the bars P {worst['P']:.3g} R {worst['R']:.3g} M "
            f"{worst['M']:.3g}; {gated}{t}  [{tag}]")
    bounds = {}
    for L, shape in METRIC_CASES[:2]:
        n, nd = math.prod(shape), shape[0] * (shape[1] - 2 * L + 1)
        # 8 bytes in per sample; P (8), R (4) and M (4) out per window
        # pair; ~20 flops per sample
        bounds[shape] = bound(8 * n + 16 * nd, 20 * n)
        log_bound(f"sc_metric L {L} {shape}", times[shape]["ms"],
                  bounds[shape])
    head, caps = (shape for _, shape in METRIC_CASES[:2])
    return {"max_abs_err": err, **times[head], **bounds[head],
            "library_ms": None,
            "captures_ms": times[caps]["ms"],
            "captures_cold_ms": times[caps]["cold_ms"],
            "captures_gated_ms": times[caps]["gated_ms"],
            "captures_bound_ms": bounds[caps]["bound_ms"]}


def tone(n: int, k: int, period: int, dev, amp: float = 1.0) -> torch.Tensor:
    """amp * exp(2 pi i k t / period), t < n, complex64; the phase index is
    reduced mod `period` in integers, so it is exact."""
    idx = (torch.arange(n, device=dev) * k) % period
    ph = idx.to(torch.float32) * (2 * np.pi / period)
    return (amp * torch.polar(torch.ones_like(ph), ph)).to(torch.complex64)


# -- 4. main path --------------------------------------------------------------

def staged_blocks(spec, n_blocks, dev, seed=0, frame=None):
    """Blocks laid out as bench.py lays them: FRAMES_PER_BLOCK golden frames
    (or copies of `frame`) at identical offsets in every block, over
    noise."""
    if frame is None:
        frame = golden_frame(spec)
    gap = (BLOCK - 2 * len(frame)) // FRAMES_PER_BLOCK
    assert gap > len(frame), "frames would overlap"
    pos = [100 + j * gap for j in range(FRAMES_PER_BLOCK)]
    blocks = noisy_buffers(n_blocks, BLOCK, seed, dev)
    add_frames(blocks, frame, pos)
    return blocks, pos


def phase_main(dev, tag: str) -> dict:
    spec = HEADLINE.spec
    sc = StreamConfig(block_size=BLOCK, max_frames_per_block=SLOTS)
    blocks, pos = staged_blocks(spec, 4, dev, seed=0)
    ex = StreamExecutor(rx_stream_block(spec, sc), BLOCK, device=dev)
    return headline_trials(ex, blocks, pos, "main", tag)


def headline_trials(ex, blocks, pos, what: str, tag: str) -> dict:
    """The headline stream through `ex` (stream_trials at N_TIMED pushes)."""
    return stream_trials(ex, HEADLINE.spec, blocks, pos, MSG, N_TIMED, what,
                         tag)[0]


def stream_trials(ex, spec, blocks, pos, msg: bytes, n_timed: int,
                  what: str, tag: str, slack: int = 0):
    """A stream of `blocks` through `ex`: a warm-up, then 3 timed trials of
    n_timed pushes from a reset carry, each ending with a readback; one
    sc_detect and one gather launch per push; one more push under sync
    debug "error"; every frame back with payload `msg`, crc_ok and a start
    inside its CP (+ `slack`).  Returns (result, the first trial's frames)."""
    H = history_len(spec)

    def trial():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [ex.push(blocks[i % len(blocks)]) for i in range(n_timed)]
        n_frames = int(torch.stack([o.result.valid.sum() for o in outs])
                       .sum().item())
        return time.perf_counter() - t0, n_frames, outs

    trial()                                   # warm-up
    ex.reset()
    reset_launches("sc_detect", "gather")
    results = [trial() for _ in range(3)]
    launches = read_launches(what, "sc_detect", "gather")
    forms = dict(kdetect.sc_detect_rows.forms)
    if set(launches.values()) != {3 * n_timed}:
        raise AssertionError(f"{what}: {launches} launches in "
                             f"{3 * n_timed} pushes, want one each a push")
    # a step must enqueue without waiting on the host: any synchronizing
    # call inside push() raises in this mode
    torch.cuda.set_sync_debug_mode("error")
    try:
        ex.push(blocks[0])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log(f"{what}: one push under sync debug mode 'error': no host sync")

    dt = min(r[0] for r in results)
    n_frames = results[0][1]
    expect = FRAMES_PER_BLOCK * n_timed
    tail = -(-H * FRAMES_PER_BLOCK // BLOCK) + 1
    if not expect - tail <= n_frames <= expect:
        raise AssertionError(f"{what}: recovered {n_frames} frames, expect "
                             f"{expect}")

    frames = collect_frames(results[0][2], block_size=BLOCK, hist=H)
    want = [i * BLOCK + p for i in range(n_timed) for p in pos]
    got = [f["abs_start"] for f in frames]
    bad = [f for f in frames
           if f["payload"] != msg or not f["crc_ok"] or not f["hdr_ok"]]
    if len(frames) != n_frames or bad:
        raise AssertionError(f"{what}: {len(bad)} frames with a wrong "
                             f"payload or CRC, first {bad[:1]}")
    off = np.asarray(got) - np.asarray(want[: len(got)])
    if not np.all((off >= 0) & (off <= spec.cp_len + slack)):
        raise AssertionError(f"{what}: detected starts off their frames' CPs"
                             f" (offsets {off.min()} .. {off.max()})")

    sps = n_timed * BLOCK / dt
    log(f"{what}: {n_frames}/{expect} frames, payload + crc_ok all good; "
        f"starts {off.min()} .. {off.max()} into their frames; "
        f"trials {[round(r[0], 4) for r in results]} s; "
        f"{sps / 1e6:.1f} Msamples/s on {today()}  [{tag}]")
    return {"msamples_per_s": sps / 1e6, "frames": n_frames,
            "launches": launches, "forms": forms}, frames


def reset_launches(*names):
    for name in names:
        WRAPPERS[name].launches = 0
        for form in getattr(WRAPPERS[name], "forms", ()):
            WRAPPERS[name].forms[form] = 0


# sc_detect's launches on the paths by kernel form, summed by read_launches
FORM_LAUNCHES = collections.Counter()


def read_launches(path: str, *names) -> dict:
    """The launch counts of `names` since reset_launches; raises if a
    kernel of the path was never launched."""
    launches = {name: WRAPPERS[name].launches for name in names}
    if "sc_detect" in names:
        FORM_LAUNCHES.update(getattr(WRAPPERS["sc_detect"], "forms", {}))
    log(f"{path}: launches {launches}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"{path} never launched {name}")
    return launches


# -- 5. wideband RX (BASELINE config 4) ---------------------------------------

def wideband_capture(dev) -> torch.Tensor:
    """One 2^25-sample wideband block: the golden frame, times n_chan, at
    per-channel offset 200 on WB_ACTIVE through the synthesis filterbank
    (bench/wideband.py's make_wideband_block, built sparsely), over
    0.01-rms noise."""
    frame = golden_frame(WIDEBAND.spec, WB_MSG)
    wide = synthesize_bursts(BLOCK, WB_CHANS, [
        (c, WB_OFFSET, frame * WB_CHANS) for c in WB_ACTIVE])
    block = torch.as_tensor(wide).to(dev)
    gen = torch.Generator(device=dev).manual_seed(40)
    block += torch.view_as_complex(
        torch.randn((BLOCK, 2), generator=gen, device=dev) * 0.01)
    return block


def wideband_executor(dev) -> StreamExecutor:
    sc = StreamConfig(block_size=BLOCK, max_frames_per_block=WB_SLOTS)
    return StreamExecutor(wideband_rx_block(WIDEBAND.spec, WB_CHANS, sc),
                          BLOCK, device=dev)


def phase_wideband(dev, tag: str) -> dict:
    spec = WIDEBAND.spec
    S = BLOCK // WB_CHANS
    block = wideband_capture(dev)
    ex = wideband_executor(dev)

    def trial():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [ex.push(block) for _ in range(WB_PUSHES)]
        counts = torch.stack([o.result.valid.sum() for o in outs]).tolist()
        return time.perf_counter() - t0, counts, outs

    trial()                                   # warm-up
    ex.reset()
    names = ("pfb", "sc_detect", "gather")
    reset_launches(*names)
    results = [trial() for _ in range(3)]
    launches = read_launches("wideband", *names)
    pfb_forms = dict(WRAPPERS["pfb"].forms)
    if pfb_forms != {"row": 0, "chan": 3 * WB_PUSHES}:
        raise AssertionError(f"wideband: pfb launches by layout {pfb_forms}"
                             f", want one channel-major a push")
    log(f"wideband: pfb launches by layout {pfb_forms}")
    torch.cuda.set_sync_debug_mode("error")
    try:
        ex.push(block)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log("wideband: one push under sync debug mode 'error': no host sync")

    for dt, counts, outs in results:
        if counts != [len(WB_ACTIVE)] * WB_PUSHES:
            raise AssertionError(f"wideband: frames per push {counts}")
        frames = collect_wideband_frames(outs, S, spec)
        steps = {int(o.block_index) for o in outs}
        for step in steps:
            got = sorted((f for f in frames
                          if f["abs_start"] // S == step),
                         key=lambda f: f["channel"])
            ok = ([f["channel"] for f in got] == list(WB_ACTIVE)
                  and all(f["payload"] == WB_MSG and f["crc_ok"]
                          and abs(f["abs_start"] - WB_OFFSET - step * S)
                          <= WB_SLACK for f in got))
            if not ok:
                raise AssertionError(f"wideband step {step}: {got}")
    dt = min(r[0] for r in results)
    sps = WB_PUSHES * BLOCK / dt
    log(f"wideband: {len(WB_ACTIVE)} frames per push on channels "
        f"{WB_ACTIVE}, payload + crc_ok + start all good in 3 trials; "
        f"trials {[round(r[0], 4) for r in results]} s; "
        f"{sps / 1e6:.1f} wideband Msamples/s  [{tag}]")
    return {"msamples_per_s": sps / 1e6, "launches": launches}


# -- 6. spectrum probe, logpwrfft and waterfall -------------------------------

def power(db) -> torch.Tensor:
    return 10.0 ** (db.cpu().double() / 10)


def compare_db(got, want, what: str, floor: float | None = None) -> None:
    """dB outputs on the card vs on the CPU, compared in linear power bin
    by bin (check_power)."""
    check_power(power(got), power(want), f"{what}, card vs CPU", floor)


SPECTRUM_PATHS = {
    "probe": lambda: spectrum_probe_block(1024, "blackman_harris"),
    "logpwr": lambda: log_pwr_fft_block(1024, avg_alpha=0.1),
    "waterfall": lambda: waterfall_block(512, depth=32),
}


def spectrum_blocks(dev) -> list[torch.Tensor]:
    """Three 2^22-sample blocks: 0.01-rms noise and a tone in bin 100 of
    1024 with twice the noise's power, ~30 dB above the noise in its bin
    and too weak to set the float32 rounding of the other bins."""
    return [noisy_buffers(1, PSD_BLOCK, seed=60 + i, dev=dev)[0] / 2
            + tone(PSD_BLOCK, PSD_TONE_BIN, 1024, dev, 0.02)
            for i in range(3)]


def phase_spectrum(dev, tag: str) -> dict:
    blocks = spectrum_blocks(dev)
    reset_launches("psd")
    on_card = {}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for name, make in SPECTRUM_PATHS.items():
        ex = StreamExecutor(make(), PSD_BLOCK, device=dev)
        on_card[name] = [ex.push(b) for b in blocks][-1]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches("spectrum", "psd")
    on_cpu = {}
    for name, make in SPECTRUM_PATHS.items():
        ex = StreamExecutor(make(), PSD_BLOCK, device="cpu")
        on_cpu[name] = [ex.push(b.cpu()) for b in blocks][-1]

    probe, probe_cpu = on_card["probe"], on_cpu["probe"]
    if not (int(probe.n_frames) == int(probe_cpu.n_frames)
            == 3 * PSD_BLOCK // 1024):
        raise AssertionError(f"probe: {int(probe.n_frames)} frames")
    # all three fields against the noise floor of the average spectrum
    floor = power(probe_cpu.avg_db).median().item()
    for field in ("avg_db", "max_db", "min_db"):
        compare_db(getattr(probe, field), getattr(probe_cpu, field),
                   f"probe {field}", floor)
    compare_db(on_card["logpwr"], on_cpu["logpwr"], "logpwrfft")
    compare_db(on_card["waterfall"], on_cpu["waterfall"], "waterfall")
    peaks = (int(probe.avg_db.argmax()),
             int(on_card["logpwr"].mean(0).argmax()),
             int(on_card["waterfall"].mean(0).argmax()))
    want = (PSD_TONE_BIN, PSD_TONE_BIN, 256 + PSD_TONE_BIN // 2)
    if peaks != want:
        raise AssertionError(f"spectrum: tone peaks at {peaks}, want {want}")
    log(f"spectrum: probe, logpwrfft and waterfall match the CPU after 3 "
        f"pushes of 2^22; tone peaks at bins {peaks}; 9 pushes in "
        f"{dt:.4f} s  [{tag}]")
    return {"launches": launches}


# -- 7. 512-channel power scan ------------------------------------------------

def scanner():
    """apps/wideband_scanner.py's power mode at SCAN_CHANS channels."""
    return power_scan_block(SCAN_CHANS)


def scan_blocks(dev) -> list[torch.Tensor]:
    """Three 2^23-sample blocks: 0.01-rms noise and SCAN_TONES on channel
    centres."""
    blocks = []
    for i in range(3):
        b = noisy_buffers(1, SCAN_BLOCK, seed=70 + i, dev=dev)[0] / 2
        for k, amp in SCAN_TONES.items():
            b += tone(SCAN_BLOCK, k, SCAN_CHANS, dev, amp)
        blocks.append(b)
    return blocks


def phase_scan(dev, tag: str) -> dict:
    blocks = scan_blocks(dev)
    reset_launches("pfb")
    ex = StreamExecutor(scanner(), SCAN_BLOCK, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pwr = torch.stack([ex.push(b) for b in blocks])
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches("scan", "pfb")
    ex_cpu = StreamExecutor(scanner(), SCAN_BLOCK, device="cpu")
    pwr_cpu = torch.stack([ex_cpu.push(b.cpu()) for b in blocks])
    e = check_power(pwr.cpu(), pwr_cpu, "scan, card vs CPU")
    top = sorted(pwr.sum(0).topk(len(SCAN_TONES)).indices.tolist())
    if top != sorted(SCAN_TONES):
        raise AssertionError(f"scan: strongest channels {top}, want "
                             f"{sorted(SCAN_TONES)}")
    log(f"scan: {SCAN_CHANS} channels, 3 pushes of 2^23 in {dt:.4f} s; "
        f"strongest channels {top} as placed; card vs CPU max abs err "
        f"{e:.3g}  [{tag}]")
    return {"launches": launches}

# -- 8. full-duplex radio loopback --------------------------------------------

def radio_traffic(spec, dev, seed: int):
    """RADIO_PUSHES input batches of SLOTS slots, the first RADIO_PDUS of
    each holding a PDU of 1-252 random bytes (lengths and bytes from
    `seed`), staged on the device; returns (inputs, PDUs per push)."""
    rng = np.random.RandomState(seed)
    cap = spec.max_payload_bytes - 4
    inputs, pdus = [], []
    for i in range(RADIO_PUSHES):
        lens = rng.randint(1, cap + 1, RADIO_PDUS)
        pay = np.zeros((SLOTS, cap), np.uint8)
        msgs = []
        for k, n in enumerate(lens):
            msgs.append(rng.randint(0, 256, n).astype(np.uint8).tobytes())
            pay[k, :n] = np.frombuffer(msgs[-1], np.uint8)
        ln = np.zeros(SLOTS, np.int32)
        ln[:RADIO_PDUS] = lens
        fn = (i * RADIO_PDUS + np.arange(SLOTS)).astype(np.int32)
        inputs.append(TxStreamIn(*(torch.as_tensor(a, device=dev) for a in (
            pay, ln, fn, np.arange(SLOTS) < RADIO_PDUS))))
        pdus.append(msgs)
    return inputs, pdus


def radio_trial(ex, chan, inputs, empty, dev):
    """One loopback run from a reset radio and channel: each push's TX
    block goes through the channel and into the RX half on the next push.
    Ends with a readback; returns (seconds, outputs)."""
    ex.reset()
    chan.reset()
    air = torch.zeros(BLOCK, dtype=torch.complex64, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = []
    for ti in inputs + [empty] * RADIO_DRAIN:
        out = ex.push((ti, air))
        air = chan.push(out.tx.samples)
        outs.append(out)
    torch.stack([o.rx.result.valid.sum() for o in outs]).sum().item()
    return time.perf_counter() - t0, outs


def check_loopback(outs, pdus, soft: bool, what: str,
                   spec=HEADLINE.spec) -> int:
    """Every queued PDU was accepted and came back exactly once, in order,
    with its payload, frame number and crc_ok; with soft output, the LLR
    signs of every frame equal its wire bits (payload + CRC32)."""
    acc = torch.stack([o.tx.accepted for o in outs[:RADIO_PUSHES]]).cpu()
    if not bool(acc[:, :RADIO_PDUS].all()) or bool(acc[:, RADIO_PDUS:].any()):
        raise AssertionError(f"{what}: TX refused a PDU or accepted an "
                             "empty slot")
    frames = collect_frames([o.rx for o in outs], block_size=BLOCK,
                            hist=history_len(spec))
    want = [(m, (i * RADIO_PDUS + k) % 4096)
            for i, msgs in enumerate(pdus) for k, m in enumerate(msgs)]
    got = [(f["payload"], f["frame_num"]) for f in frames]
    if got != want or not all(f["crc_ok"] for f in frames):
        bad = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                   min(len(got), len(want)))
        raise AssertionError(f"{what}: {len(got)} frames back for "
                             f"{len(want)} PDUs, first mismatch at {bad}")
    if soft:
        check_llr_signs(frames, what)
    return len(frames)


def check_llr_signs(frames, what: str) -> None:
    """Every frame's LLR signs equal its wire bits (payload + CRC32)."""
    for f in frames:
        wire = f["payload"] + zlib.crc32(f["payload"]).to_bytes(4, "little")
        bits = np.unpackbits(np.frombuffer(wire, np.uint8))
        if not np.array_equal(f["llr"] < 0, bits.astype(bool)):
            raise AssertionError(f"{what}: LLR signs differ from the "
                                 f"bits of frame {f['frame_num']}")


def radio_executor(dev, spec=HEADLINE.spec, **options) -> StreamExecutor:
    """The radio at `spec` (the headline's by default); options go to
    ofdm_radio."""
    sc = StreamConfig(block_size=BLOCK, max_frames_per_block=SLOTS)
    return StreamExecutor(ofdm_radio(spec, sc, **options), BLOCK, device=dev)


def radio_channel(dev, snr_db=RADIO_SNR, cfo=RADIO_CFO,
                  fft_len=HEADLINE.spec.fft_len, taps=None) -> StreamExecutor:
    return StreamExecutor(channel_block(seed=91, snr_db=snr_db, cfo=cfo,
                                        fft_len=fft_len, taps=taps),
                          BLOCK, device=dev)


def phase_radio(dev, tag: str) -> dict:
    spec = HEADLINE.spec
    inputs, pdus = radio_traffic(spec, dev, seed=90)
    empty = empty_tx_in(spec, SLOTS, dev)
    chan = radio_channel(dev)
    ex = radio_executor(dev)
    radio_trial(ex, chan, inputs, empty, dev)               # warm-up
    names = ("sc_detect", "gather")
    reset_launches(*names)
    trials = [radio_trial(ex, chan, inputs, empty, dev) for _ in range(3)]
    launches = read_launches("radio", *names)
    for i, (_, outs) in enumerate(trials):
        n = check_loopback(outs, pdus, False, f"radio hard trial {i}")
    pushes = RADIO_PUSHES + RADIO_DRAIN
    dt = min(t for t, _ in trials)
    sps = pushes * BLOCK / dt
    log(f"radio hard/pilot_phase: {n} of {n} PDUs back once with payload "
        f"and crc_ok in each of 3 trials; trials "
        f"{[round(t, 4) for t, _ in trials]} s for {pushes} pushes; "
        f"{sps / 1e6:.1f} Msamples/s per direction  [{tag}]")

    air = chan.push(trials[0][1][-1].tx.samples)
    torch.cuda.set_sync_debug_mode("error")
    try:
        ex.push((inputs[0], air))
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log("radio: one push under sync debug mode 'error': no host sync")

    soft = radio_executor(dev, equalizer="simpledfe", output="soft")
    radio_trial(soft, chan, inputs, empty, dev)             # warm-up
    t_soft, outs = radio_trial(soft, chan, inputs, empty, dev)
    n = check_loopback(outs, pdus, True, "radio soft/simpledfe")
    log(f"radio soft/simpledfe: {n} PDUs back with crc_ok, LLR signs = the "
        f"wire bits on every frame; {t_soft:.4f} s for {pushes} pushes, "
        f"{pushes * BLOCK / t_soft / 1e6:.1f} Msamples/s per direction  "
        f"[{tag}]")
    return {"msamples_per_s": sps / 1e6, "launches": launches}


# -- 9. sync diagnostics: CFO estimator statistics, moving sums ---------------

def moose_var(L: int, rho: float) -> float:
    """Fine-CFO variance in subcarrier units at per-sample SNR rho
    (Moose 1994, eq. 12; tests/test_cfo_stats.py)."""
    return (1.0 / (math.pi ** 2 * L)) * (1.0 / rho + 1.0 / (2.0 * rho ** 2))


def sync_captures(frame, fft_len, cp, snr_db, dev, seed):
    """SYNC_TRIALS captures of SYNC_N samples: the frame at SYNC_P0 with
    CFO SYNC_CFO, plus noise at snr_db against the sync symbol's power.
    Returns (captures, rho, readout index of P at the plateau)."""
    ph = np.exp(2j * np.pi * SYNC_CFO * np.arange(len(frame)) / fft_len)
    sig = np.zeros(SYNC_N, np.complex64)
    sig[SYNC_P0:SYNC_P0 + len(frame)] = frame * ph
    d = SYNC_P0 + cp
    es = float(np.mean(np.abs(sig[d:d + fft_len]) ** 2))
    sigma2 = es / 10 ** (snr_db / 10)
    gen = torch.Generator(device=dev).manual_seed(seed)
    z = torch.randn((SYNC_TRIALS, SYNC_N, 2), generator=gen, device=dev)
    r = torch.view_as_complex(z * math.sqrt(sigma2 / 2))
    return r + torch.as_tensor(sig, device=dev), es / sigma2, d


def compare_sync(spec, r, got, want, what: str):
    """schmidl_cox on the card vs on the CPU, where it runs sc_metric's
    float64 plain version: check_sc_metric's bars, 1e-5 E for P and R
    (E = R1 + R2) and 1e-4 (E/R) (E/R + 2M) for M.  M is compared where
    both routes make the same gate decision; a position where they differ
    must lie within 1e-4 of the local energy of the gate's threshold (R
    itself is good to 1e-5 E <= ~2e-5 of it)."""
    Pc, Rc, Mc = got.corr.cpu(), got.energy.cpu(), got.metric.cpu()
    E = pair_energy(r, spec.fft_len // 2)
    worst = {}
    for name, a, b in (("P", Pc, want.corr), ("R", Rc, want.energy)):
        worst[name] = ((a - b).abs().double() / (1e-5 * E)).max().item()
    local = coarse_sliding_max_same(want.energy, 2 * spec.sym_len + 1)
    near = (want.energy - 0.05 * local).abs() <= 1e-4 * local
    flip = (Mc > 0) != (want.metric > 0)
    if bool((flip & ~near).any()):
        raise AssertionError(f"{what}: gate decisions differ away from the "
                             "threshold")
    same = ~flip
    q = E / want.energy.double()
    bar = 1e-4 * q * (q + 2 * want.metric.double())
    worst["M"] = ((Mc - want.metric).abs().double() / bar)[same].max().item()
    if not all(w <= 1.0 for w in worst.values()):
        raise AssertionError(f"{what}: worst ratios to the bars {worst}")
    log(f"  {what}: worst ratio to the bars P {worst['P']:.3g} R "
        f"{worst['R']:.3g} M {worst['M']:.3g}; {int(flip.sum())} gate "
        "decisions differ, all at the threshold")


def check_moving_sum(x, w: int, what: str) -> float:
    """moving_sum on the card against window sums taken directly in
    float64, per real component.  The card's sum is the difference of two
    float32 roundings of float64 prefixes C, itself rounded once, so the
    bar is 2^-23 (|C[d+w-1]| + |C[d-1]| + |S[d]|): twice the ulps at the
    prefix's magnitude."""
    got = moving_sum(x, w)
    parts = ([(got.real, x.real), (got.imag, x.imag)] if x.is_complex()
             else [(got, x)])
    ratio = e = 0.0
    for g, v in parts:
        C = torch.cumsum(v.double(), -1)
        lag = torch.cat([C.new_zeros(1), C[: C.shape[-1] - w]])
        S = C[w - 1:] - lag
        d = (g.double() - S).abs()
        bar = 2.0 ** -23 * (C[w - 1:].abs() + lag.abs() + S.abs()) + 1e-30
        ratio = max(ratio, (d / bar).max().item())
        e = max(e, d.max().item())
    if not ratio <= 1.0:
        raise AssertionError(f"{what}: {ratio:.3g} of its bar")
    log(f"  {what}: max abs err {e:.3g} against float64 window sums, worst "
        f"at {ratio:.3g} of its bar")
    return e


def phase_sync(dev, tag: str) -> dict:
    spec = HEADLINE.spec
    L = spec.fft_len // 2
    cap = spec.max_payload_bytes - 4
    payload = torch.zeros(cap, dtype=torch.uint8, device=dev)
    payload[:32] = torch.arange(32, device=dev)
    fr = tx_frame(spec, payload, 32)
    frame = fr.samples[: int(fr.n_samples)].cpu().numpy()
    gold = golden_frame(spec, bytes(range(32)))
    if len(frame) != len(gold) or np.abs(frame - gold).max() > 1e-5:
        raise AssertionError("sync: port TX frame differs from the golden")
    names = ("sc_metric", "scan")
    reset_launches(*names)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for snr_db in SYNC_SNRS:
        r, rho, d = sync_captures(frame, spec.fft_len, spec.cp_len, snr_db,
                                  dev, seed=int(snr_db))
        sm = schmidl_cox(spec, r)
        err = (torch.angle(sm.corr[:, d]) / math.pi - SYNC_CFO).double()
        var = err.var(unbiased=False).item()
        mean = err.mean().item()
        want = moose_var(L, rho)
        if not 0.6 * want < var < 1.8 * want:
            raise AssertionError(f"sync {snr_db} dB: var {var:.4g}, Moose "
                                 f"{want:.4g}")
        if not abs(mean) < 4 * math.sqrt(var / SYNC_TRIALS) + 1e-3:
            raise AssertionError(f"sync {snr_db} dB: bias {mean:.3g}")
        log(f"sync {snr_db:g} dB: fine-CFO var {var:.4g} = "
            f"{var / want:.3f} x Moose over {SYNC_TRIALS} captures, bias "
            f"{mean:.2g}")
        r16 = r[:16].cpu()
        compare_sync(spec, r16, type(sm)(*(v[:16] for v in sm)),
                     schmidl_cox(spec, r16),
                     f"schmidl_cox {snr_db:g} dB, 16 captures card vs CPU")
    gen = torch.Generator(device=dev).manual_seed(95)
    x = torch.randn(1 << 25, generator=gen, device=dev) ** 2
    z = torch.view_as_complex(torch.randn((1 << 25, 2), generator=gen,
                                          device=dev))
    check_moving_sum(x, L, "moving_sum 2^25 float32")
    check_moving_sum(z, L, "moving_sum 2^25 complex64")
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches("sync", *names)
    if launches["sc_metric"] != len(SYNC_SNRS):
        raise AssertionError(f"sync: {launches['sc_metric']} sc_metric "
                             f"launches for {len(SYNC_SNRS)} schmidl_cox "
                             "calls on the card")
    log(f"sync: 3 x {SYNC_TRIALS} captures and 2 moving sums of 2^25, with "
        f"the CPU comparisons, in {dt:.4f} s  [{tag}]")
    return {"launches": launches}


# -- 10. the flowgraph layer, the examples and the apps -----------------------

EXAMPLES = ROOT / "examples"
# the headline receiver as a one-node spec, through grc.build
HEADLINE_SPEC = {
    "name": "headline_rx",
    "blocks": [{"id": "rx", "type": "ofdm_rx_stream", "params": {
        "block_size": BLOCK, "max_frames_per_block": SLOTS, "fft_len": 64,
        "cp_len": 16, "modulation": "qpsk", "max_payload_bytes": 256}}],
    "inputs": ["rx"], "outputs": ["rx"],
}
# a power meter: |x|^2 -> moving sum of 1024 -> dB, on PSD_BLOCK pushes
METER_SPEC = {
    "name": "power_meter",
    "blocks": [{"id": "mag", "type": "complex_to_mag_squared"},
               {"id": "avg", "type": "moving_average", "params": {"n": 1024}},
               {"id": "db", "type": "nlog10"}],
    "connections": [["mag", "avg"], ["avg", "db"]],
    "inputs": ["mag"], "outputs": ["db"],
}
# examples/README.md's run_flowgraph lines, noise added under the probe's
# tone: example -> (arguments, the kernels each step launches once, the
# quantile of the CPU's first dB output that check_power takes as the
# floor of the later ones; the first is held to its own median).  The
# probe's lowpass puts over half its bins ~57 dB under its passband; there
# float32 rounding alone (of the PSD on an exact FIR too) puts the max and
# min over frames several and hundreds of times their own bar off the
# float64 answer (probe_readings logs it), so they are held to the
# passband's noise floor, the 75th percentile of the average spectrum.
EXAMPLE_RUNS = {
    "psd_probe": (["--tone", "0.125", "--noise", "0.1"], ("psd",), 0.75),
    "decimate_and_measure": (["--tone", "0.25"], (), 0.5),
    "channelizer_waterfall": (["--noise", "1.0", "--block-size", "32768",
                               "--steps", "5"], ("pfb", "psd"), 0.5),
}
LOOPBACK_PDUS = 8        # two pushes of the example's 4 TX slots
# the loopback app's frames are 1140 samples apart and its RX holds 8 slots
# a block: at its default block of 16384 both packages recover 40 of 64
APP_FRAMES, APP_BLOCK = 64, 8192
# the scan's weakest tone (0.25, channel 257) reads 42 dBFS, the strongest
# one's neighbours 14 dBFS, the noise near -10
SCAN_THRESHOLD_DB = 30.0


def quiet(fn, *args):
    """fn(*args) with its standard output captured: (result, output)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args)
    return out, buf.getvalue()


def example_runs(dev, tmp: pathlib.Path,
                 counts: collections.Counter) -> None:
    """Three examples through run_flowgraph.main on the card and on the
    CPU: the card's launches (one per step of each kernel the graph runs)
    and its final output against the CPU's."""
    for name, (args, kernels, q) in EXAMPLE_RUNS.items():
        spec = str(EXAMPLES / f"{name}.json")
        steps = int(args[args.index("--steps") + 1]) if "--steps" in args \
            else 10
        saved = {}
        for where, device in (("card", str(dev)), ("cpu", "cpu")):
            saved[where] = tmp / f"{name}_{where}.npz"
            reset_launches(*kernels)
            rc, out = quiet(run_flowgraph.main, [
                spec, *args, "--device", device, "--save-output",
                str(saved[where])])
            if rc != 0:
                raise AssertionError(f"run_flowgraph {name} on {device}: "
                                     f"rc {rc}\n{out}")
            if where == "card":
                log(f"  run_flowgraph {name}: {out.splitlines()[1]}")
                launches = read_launches(f"run_flowgraph {name}", *kernels)
                if set(launches.values()) - {steps}:
                    raise AssertionError(f"{name}: {launches} launches in "
                                         f"{steps} steps")
                counts.update(launches)
        card, cpu = np.load(saved["card"]), np.load(saved["cpu"])
        floor = None     # then from the first dB output (the probe's avg)
        for key in sorted(cpu.files):
            a, b = torch.as_tensor(card[key]), torch.as_tensor(cpu[key])
            what = f"{name} {key}, card vs CPU"
            if a.is_complex():
                check_close(a, b, 2e-4, what)
            elif a.dtype == torch.int32:
                if not torch.equal(a, b):
                    raise AssertionError(f"{what}: {a} != {b}")
            else:
                want = power(b)
                check_power(power(a), want, what, floor)
                if floor is None:
                    floor = want.flatten().quantile(q).item()
        if name == "psd_probe":
            probe_readings(card, cpu, probe_witness(args, steps), floor)


def probe_witness(args: list[str], steps: int):
    """examples/psd_probe.json in float64 on the host, on the samples that
    run_flowgraph feeds it at its default block: the lowpass as a direct
    convolution, hann frames, |DFT|^2 / norm, and the avg, max and min over
    every frame, in linear power; and the same statistics of the float32
    PSD (psd_fused_plain on the CPU) of that exact FIR output."""
    spec = json.loads((EXAMPLES / "psd_probe.json").read_text())
    taps = grc._resolve_taps(spec["blocks"][0]["params"]["taps"])
    n = spec["blocks"][1]["params"]["fft_len"]
    p = argparse.ArgumentParser()
    add_source_args(p)
    src = make_source(p.parse_args(args), 1 << 15)
    x = np.concatenate([next(src) for _ in range(steps)]).astype(np.complex128)
    y = np.convolve(x, taps.astype(np.float64))[: x.shape[0]]
    w, norm = kpsd.window_norm(n, "hann")
    exact = torch.as_tensor(np.abs(np.fft.fft(y.reshape(-1, n) * w)) ** 2
                            / norm)
    psd32 = kpsd.psd_fused_plain(torch.as_tensor(y.astype(np.complex64)), n,
                                 "hann").double()
    return [[p.mean(0), p.amax(0), p.amin(0)] for p in (exact, psd32)]


def probe_readings(card, cpu, witness, floor: float) -> None:
    """The probe's avg, max and min on the card against the float64
    witness, each at the floor card vs CPU is held to (the avg at its own
    median); then, logged, each pair at the output's own median floor
    (check_power's default), where the stopband bins are held to their own
    size."""
    for i, (wit, p32) in enumerate(zip(*witness)):
        key = f"out_{i}"
        a = power(torch.as_tensor(card[key]))
        b = power(torch.as_tensor(cpu[key]))
        check_power(a, wit, f"psd_probe {key}, card vs float64",
                    floor if i else None)
        pairs = (("card vs CPU", a, b), ("card vs float64", a, wit),
                 ("CPU vs float64", b, wit),
                 ("float32 PSD of the exact FIR vs float64", p32, wit))
        log(f"  psd_probe {key} at its median floor "
            f"{wit.median().item():.3g}: worst bin at " + ", ".join(
                f"{power_ratio(g, w)[0]:.3g} ({what})" for what, g, w in pairs)
            + " of its bar")


def example_loopback(dev, counts: collections.Counter) -> None:
    """examples/ofdm_loopback.json (TX -> channel -> RX, driven with PDU
    batches staged on the device) on the card and on the CPU: every PDU
    back once with its payload and crc_ok on both; one sc_detect and one
    gather launch per push on the card."""
    path = str(EXAMPLES / "ofdm_loopback.json")
    spec = OfdmConfig(modulation="qpsk", max_payload_bytes=64).spec
    msgs = [b"chip_smoke loopback pdu %d" % i for i in range(LOOPBACK_PDUS)]
    want = [(i, m, True) for i, m in enumerate(msgs)]
    for device in (dev, torch.device("cpu")):
        feeds = [queue_tx_in(spec, 4, msgs[i:i + 4], i, device=device)[0]
                 for i in range(0, LOOPBACK_PDUS, 4)]
        feeds += [empty_tx_in(spec, 4, device)] * 6
        ex = StreamExecutor(grc.load(path), 4096, device=device)
        if device == dev:
            reset_launches("sc_detect", "gather")
        outs = [ex.push(ti) for ti in feeds]
        if device == dev:
            launches = read_launches("loopback example", "sc_detect",
                                     "gather")
            if set(launches.values()) != {len(feeds)}:
                raise AssertionError(f"loopback example: {launches} "
                                     f"launches in {len(feeds)} pushes")
            counts.update(launches)
        if not all(bool(o[1].all()) for o in outs[: LOOPBACK_PDUS // 4]):
            raise AssertionError(f"loopback example on {device}: a PDU "
                                 "was refused")
        frames = collect_frames([o[0] for o in outs], 4096, history_len(spec))
        got = sorted((f["frame_num"], f["payload"], f["crc_ok"])
                     for f in frames)
        if got != want:
            raise AssertionError(f"loopback example on {device}: {got}")
    log(f"  loopback example: {LOOPBACK_PDUS} of {LOOPBACK_PDUS} PDUs back "
        "once with payload and crc_ok, on the card and on the CPU")


def check_meter(got_db, want_db, prev, x, what: str) -> None:
    """Power meter outputs, card vs CPU, as window sums of |x|^2 over
    [prev | x]: both take each sum as a difference of two float32 roundings
    of float64 prefixes C (kernels/scan.py), so each is within 2^-23 (|C_hi|
    + |C_lo| + |S|) of the exact sum S, and the two within twice that, plus
    2e-6 S for |x|^2 and the dB round trip in float32."""
    w = METER_SPEC["blocks"][1]["params"]["n"]
    C = torch.cumsum(torch.cat([prev, x]).cpu().to(torch.complex128).abs()
                     ** 2, 0)
    hi = C[w - 1:]
    lo = torch.cat([C.new_zeros(1), C[: C.shape[0] - w]])
    S = hi - lo
    bar = 2.0 ** -22 * (hi + lo + S) + 2e-6 * S
    ratio = ((power(got_db) - power(want_db)).abs() / bar).max().item()
    if not ratio <= 1.0:
        raise AssertionError(f"{what}: {ratio:.3g} of its bar")
    log(f"  {what}: worst sample at {ratio:.3g} of its bar")


def power_meter(dev, counts: collections.Counter, tag: str) -> None:
    """METER_SPEC on 3 spectrum blocks of 2^22: one scan launch per push;
    the card's window sums against the CPU's (check_meter)."""
    blocks = spectrum_blocks(dev)
    ex = StreamExecutor(grc.build(METER_SPEC), PSD_BLOCK, device=dev)
    ex.push(blocks[0])                                      # warm-up
    ex.reset()
    reset_launches("scan")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = [ex.push(b) for b in blocks]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_launches("power meter", "scan")
    if launches["scan"] != len(blocks):
        raise AssertionError(f"power meter: {launches} in {len(blocks)} "
                             "pushes")
    counts.update(launches)
    cpu = StreamExecutor(grc.build(METER_SPEC), PSD_BLOCK, device="cpu")
    prev = blocks[0].new_zeros(METER_SPEC["blocks"][1]["params"]["n"] - 1)
    for i, (b, o) in enumerate(zip(blocks, outs)):
        check_meter(o, cpu.push(b.cpu()), prev, b,
                    f"power meter push {i}, card vs CPU")
        prev = b[b.shape[0] - prev.shape[0]:]
    log(f"  power meter: 3 pushes of 2^22 in {dt:.4f} s, "
        f"{3 * PSD_BLOCK / dt / 1e6:.1f} Msamples/s  [{tag}]")


def scanner_file(dev, tmp: pathlib.Path) -> str:
    """Phase 7's three blocks written to a complex64 capture file."""
    path = str(tmp / "scan512.c64")
    write, close = file_sink(path)
    for b in scan_blocks(dev):
        write(b.cpu().numpy())
    close()
    return path


def apps_on_card(dev, tmp: pathlib.Path, counts: collections.Counter) -> None:
    """The three apps: ofdm_loopback at APP_FRAMES frames through an
    impaired channel returns 0; the 512-channel power scan flags exactly
    the tone channels; the spectrum logger's snapshots on the card equal
    the CPU's."""
    reset_launches("sc_detect", "gather")
    rc, out = quiet(ofdm_loopback.main, [
        "--frames", str(APP_FRAMES), "--snr", "25", "--cfo", "0.1",
        "--multipath", "--block-size", str(APP_BLOCK), "--device", str(dev)])
    n_ok = sum(line.startswith("OK ") for line in out.splitlines())
    if rc != 0 or n_ok != APP_FRAMES:
        raise AssertionError(f"ofdm_loopback: rc {rc}, {n_ok} frames OK")
    counts.update(read_launches("ofdm_loopback app", "sc_detect", "gather"))
    log(f"  ofdm_loopback app: {n_ok} of {APP_FRAMES} frames OK (25 dB, "
        "CFO 0.1, multipath)")

    reset_launches("pfb")
    rc, out = quiet(wideband_scanner.main, [
        "--file", scanner_file(dev, tmp), "--channels", str(SCAN_CHANS),
        "--block-size", str(SCAN_BLOCK), "--blocks", "3",
        "--threshold", str(SCAN_THRESHOLD_DB), "--device", str(dev)])
    flagged = sorted(int(line.split()[1]) for line in out.splitlines()
                     if line.startswith("ch ") and line.endswith("*"))
    if rc != 0 or flagged != sorted(SCAN_TONES):
        raise AssertionError(f"wideband_scanner: rc {rc}, flagged {flagged}")
    counts.update(read_launches("wideband_scanner app", "pfb"))
    log(f"  wideband_scanner app: {SCAN_CHANS} channels, flagged {flagged}")

    logs = {}
    for where, device in (("card", str(dev)), ("cpu", "cpu")):
        stem = str(tmp / f"speclog_{where}")
        if where == "card":
            reset_launches("psd")
        rc, _ = quiet(spectrum_logger.main, [
            "--tone", "0.1", "--noise", "0.1", "--blocks-per-snapshot", "2",
            "--snapshots", "3", "--out", stem, "--device", device])
        if rc != 0:
            raise AssertionError(f"spectrum_logger on {device}: rc {rc}")
        if where == "card":
            counts.update(read_launches("spectrum_logger app", "psd"))
        with open(stem + ".jsonl") as f:
            logs[where] = (np.load(stem + ".npz"),
                            [json.loads(line) for line in f])
    (card, card_lines), (cpu, cpu_lines) = logs["card"], logs["cpu"]
    for key in ("avg_db", "max_db"):
        check_power(power(torch.as_tensor(card[key])),
                    power(torch.as_tensor(cpu[key])),
                    f"spectrum_logger {key}, card vs CPU")
    bins = [(a["peak_bin"], a["n_frames"]) for a in card_lines]
    if bins != [(b["peak_bin"], b["n_frames"]) for b in cpu_lines] \
            or len(bins) != 3:
        raise AssertionError(f"spectrum_logger: {card_lines} vs {cpu_lines}")
    log(f"  spectrum_logger app: 3 snapshots, peak bins and frame counts "
        f"{bins} as on the CPU")


def check_c1_routes(dev) -> None:
    """The shapes the kernels do not cover compute on the card as the JAX
    package's XLA chain does, with no launch, and equal the CPU; every
    covered shape launches its kernel once."""
    x = noisy_buffers(1, 1 << 20, seed=80, dev=dev)[0]
    for N in kpsd.COVERED:
        before = kpsd.psd_fused.launches
        psd_frames(x, N)
        if kpsd.psd_fused.launches != before + 1:
            raise AssertionError(f"psd_frames at N {N} did not launch psd")
    for xs, N in ((x, 2048), (x, 48), (x.view(4, -1), 2048)):
        before = kpsd.psd_fused.launches
        got = psd_frames(xs, N, "blackman_harris")
        if kpsd.psd_fused.launches != before:
            raise AssertionError(f"psd_frames at N {N} launched psd")
        check_power(got.cpu(), psd_frames(xs.cpu(), N, "blackman_harris"),
                    f"psd_frames N {N} over {tuple(xs.shape)} (torch route), "
                    "card vs CPU")
    for xs, N in ((x[: 1 << 19].view(2, -1), WB_CHANS), (x[: 48 << 13], 48)):
        taps = lowpass_taps(N)
        poly = torch.as_tensor(polyphase_decompose(taps, N), device=dev)
        tail = torch.zeros((*xs.shape[:-1], kpfb.tail_len(N, poly.shape[0])),
                           dtype=torch.complex64, device=dev)
        before = kpfb.channelize_fused.launches
        got = channelize(xs, N, taps)
        half = xs.shape[-1] // 2 // N * N
        a, tail = channelize_stream(xs[..., :half].contiguous(), tail, N, poly)
        b, _ = channelize_stream(xs[..., half:].contiguous(), tail, N, poly)
        if kpfb.channelize_fused.launches != before:
            raise AssertionError(f"channelize of {tuple(xs.shape)} at {N} "
                                 "channels launched pfb")
        want = channelize(xs.cpu(), N, taps)
        what = f"channelize {tuple(xs.shape)} at {N} channels (torch route)"
        check_close(got.cpu(), want, 2e-4, f"{what}, card vs CPU")
        check_close(torch.cat([a, b], dim=-2).cpu(), want[..., : (2 * half)
                                                          // N, :],
                    2e-4, f"{what}, two carried steps vs one-shot on the CPU")


def ddc_sync_free(dev) -> None:
    """One push of examples/decimate_and_measure.json (after a warm-up push
    that builds its constants on the card) under sync debug "error"."""
    bs = 1 << 15
    ex = StreamExecutor(grc.load(str(EXAMPLES / "decimate_and_measure.json")),
                        bs, device=dev)
    x = tone(bs, bs // 4, bs, dev)
    ex.push(x)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        ex.push(x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log("  DDC graph: one push under sync debug mode 'error': no host sync")


def phase_flowgraph(dev, tag: str, main_rate: float) -> dict:
    counts = collections.Counter()
    blocks, pos = staged_blocks(HEADLINE.spec, 4, dev, seed=0)
    ex = StreamExecutor(grc.build(HEADLINE_SPEC), BLOCK, device=dev)
    if ex.block.name != "headline_rx":
        raise AssertionError(f"grc.build named the graph {ex.block.name!r}")
    res = headline_trials(ex, blocks, pos, "flowgraph headline", tag)
    counts.update(res["launches"])
    log(f"flowgraph headline through grc.build: {res['msamples_per_s']:.1f} "
        f"Msamples/s beside phase 4's {main_rate:.1f}  [{tag}]")
    del ex, blocks
    torch.cuda.empty_cache()
    ddc_sync_free(dev)
    with tempfile.TemporaryDirectory() as d:
        tmp = pathlib.Path(d)
        example_runs(dev, tmp, counts)
        example_loopback(dev, counts)
        power_meter(dev, counts, tag)
        apps_on_card(dev, tmp, counts)
    check_c1_routes(dev)
    log(f"flowgraph: launches over the phase {dict(counts)}")
    return {"launches": dict(counts)}


# -- 11. ingest and recovery ----------------------------------------------------

INGEST_BLOCKS = 6
INGEST_SHIFT = 2000      # every block's frames sit this far past staged_blocks'
INGEST_SEAM = 3          # one more frame starts INGEST_LEAD before this block
INGEST_LEAD = 1000
INGEST_CUT = 3           # checkpoint after blocks 0 .. INGEST_CUT - 1
INGEST_DROP = 4          # the block inject_faults drops
INGEST_DEPTH = 3         # DeviceFeed depth
INGEST_TRACED = 3        # pushes under metrics.trace
# the program's stages in the trace: the profiler records the thread that
# started it, not the feed's worker (feed.fill, file.read, file.convert)
TRACED_STAGES = ("executor.push", "rx.detect", "rx.demod", "feed.wait")
WATCHDOG_S = 10.0
CHAT_MSGS = ["chip_smoke chat on the card", "second message"]
ANALYZER_BLOCK = 1 << 17
ANALYZER_PUSHES = 8
ANALYZER_TONE_BIN = 256  # --tone 0.25 of --fft-len 1024


def ingest_block(spec, i: int, dev) -> torch.Tensor:
    """Block i of the capture: staged_blocks' layout (FRAMES_PER_BLOCK
    golden frames over 0.02-rms noise) with every frame INGEST_SHIFT later,
    and the two parts of one more frame (frame_num 1) across the seam
    before block INGEST_SEAM."""
    frame = golden_frame(spec)
    seam = golden_frame(spec, frame_num=1)
    gap = (BLOCK - 2 * len(frame)) // FRAMES_PER_BLOCK
    b = noisy_buffers(1, BLOCK, seed=110 + i, dev=dev)
    add_frames(b, frame, [INGEST_SHIFT + 100 + j * gap
                          for j in range(FRAMES_PER_BLOCK)])
    if i == INGEST_SEAM - 1:
        b[0, BLOCK - INGEST_LEAD:] += torch.as_tensor(seam[:INGEST_LEAD],
                                                      device=dev)
    if i == INGEST_SEAM:
        b[0, : len(seam) - INGEST_LEAD] += torch.as_tensor(
            seam[INGEST_LEAD:], device=dev)
    return b[0]


def ingest_expected(spec) -> list[tuple[int, int]]:
    """(absolute start, frame_num) of every frame of the capture, sorted."""
    frame = golden_frame(spec)
    gap = (BLOCK - 2 * len(frame)) // FRAMES_PER_BLOCK
    want = [(i * BLOCK + INGEST_SHIFT + 100 + j * gap, 0)
            for i in range(INGEST_BLOCKS) for j in range(FRAMES_PER_BLOCK)]
    return sorted(want + [(INGEST_SEAM * BLOCK - INGEST_LEAD, 1)])


def host_planes(x: torch.Tensor) -> np.ndarray:
    """A complex64 block as (2, n) float32 (re, im) planes on the host."""
    return torch.view_as_real(x).T.contiguous().cpu().numpy()


def write_capture(spec, dev, tmp: pathlib.Path) -> dict:
    """The capture as an i16c file (sc16, scaled so that the peak is full
    scale) and block 0 alone as an f32c file."""
    peak = max(torch.view_as_real(ingest_block(spec, i, dev)).abs().max()
               .item() for i in range(INGEST_BLOCKS))
    paths = {"i16c": str(tmp / "capture.i16c"), "f32c": str(tmp / "block0.f32c"),
             "peak": peak}
    with open(paths["i16c"], "wb") as f:
        for i in range(INGEST_BLOCKS):
            real, imag = host_planes(ingest_block(spec, i, dev))
            f.write(runtime.from_planar(real, imag, "i16c",
                                        scale=32767 / peak))
    with open(paths["f32c"], "wb") as f:
        real, imag = host_planes(ingest_block(spec, 0, dev))
        f.write(runtime.from_planar(real, imag, "f32c"))
    return paths


def capture_streamer(paths: dict, fmt: str = "i16c") -> FileStreamer:
    """The capture's FileStreamer, its ring two blocks long."""
    item = {"i16c": 4, "f32c": 8}[fmt]
    return FileStreamer(paths[fmt], fmt, block_size=BLOCK,
                        ring_bytes=2 * BLOCK * item,
                        scale=paths["peak"] / 32767 if fmt == "i16c" else None)


def ingest_executor(dev) -> StreamExecutor:
    sc = StreamConfig(block_size=BLOCK, max_frames_per_block=SLOTS)
    return StreamExecutor(rx_stream_block(HEADLINE.spec, sc), BLOCK,
                          device=dev)


@contextlib.contextmanager
def no_host_sync():
    """Any synchronizing CUDA call inside raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


class TimedReads:
    """A FileStreamer as DeviceFeed's planar source, keeping each block's
    (read, convert) seconds: the wait for the reader thread's bytes, then
    the conversion into the feed's pinned planes."""

    def __init__(self, fs: FileStreamer):
        self.fs, self.block, self.times = fs, fs.block, []

    def read_into(self, re, im) -> int:
        n = self.fs.read_into(re, im)
        if n:
            self.times.append(self.fs.last_times)
        return n


@contextlib.contextmanager
def timed(pc: PerfCounters, times: dict, name: str):
    """pc's stage `name`, its seconds also appended to times[name]."""
    t0 = time.perf_counter()
    with pc.stage(name, items=BLOCK):
        yield
    times[name].append(time.perf_counter() - t0)


def ingest_run(source, ex, dev, pc: PerfCounters, sync_push: int = -1):
    """Every block that a DeviceFeed stages from `source`, pushed through
    `ex` (push number `sync_push` under sync debug "error"), then one zero
    block to drain the receiver's history.  Returns (outputs, seconds from
    the first block's fetch to the card's end of the last, the feed, each
    block's host seconds waiting for the feed and enqueueing the push)."""
    feed = DeviceFeed(source, depth=INGEST_DEPTH, device=dev)
    outs, times = [], {"feed": [], "push": []}
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    blocks = iter(feed)
    while True:
        with timed(pc, times, "feed"):
            x = next(blocks, None)
        if x is None:
            break
        with timed(pc, times, "push"):
            if len(outs) == sync_push:
                with no_host_sync():
                    outs.append(ex.push(x))
            else:
                outs.append(ex.push(x))
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    outs.append(ex.push(torch.zeros(BLOCK, dtype=torch.complex64,
                                    device=dev)))
    return outs, dt, feed, times


def block_ms(seconds: list[float]) -> dict:
    """Per-block ms: the first block's, and the mean, min and max of the
    blocks after it (the first pays the reader's start and the pinned
    slots' allocation)."""
    rest = [1e3 * t for t in seconds[1:]]
    return {"first": 1e3 * seconds[0], "mean": sum(rest) / len(rest),
            "min": min(rest), "max": max(rest)}


def frame_key(f: dict) -> tuple:
    return (f["abs_start"], f["frame_num"], f["payload"], f["crc_ok"])


def check_ingest_frames(spec, frames, want, what: str) -> None:
    """Exactly the frames `want` [(start, frame_num)], each once, with the
    payload MSG, crc_ok, hdr_ok and a detected start inside its CP."""
    got = sorted(frames, key=lambda f: f["abs_start"])
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} frames, want {len(want)}")
    bad = [f for f in got
           if f["payload"] != MSG or not f["crc_ok"] or not f["hdr_ok"]]
    if bad:
        raise AssertionError(f"{what}: {len(bad)} frames with a wrong "
                             f"payload or CRC, first {bad[:1]}")
    if [f["frame_num"] for f in got] != [n for _, n in want]:
        raise AssertionError(f"{what}: frame numbers differ")
    off = (np.asarray([f["abs_start"] for f in got])
           - np.asarray([p for p, _ in want]))
    if not np.all((off >= 0) & (off <= spec.cp_len)):
        raise AssertionError(f"{what}: detected starts off their frames' CPs")


def named_leaves(tree, prefix: str = "out"):
    """(path, tensor) of each leaf of a NamedTuple / tuple tree."""
    if hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from named_leaves(getattr(tree, name), f"{prefix}.{name}")
    elif isinstance(tree, (tuple, list)):
        for i, t in enumerate(tree):
            yield from named_leaves(t, f"{prefix}[{i}]")
    else:
        yield prefix, tree


def raw_bits(t: torch.Tensor) -> torch.Tensor:
    t = t.reshape(-1)
    if t.is_complex():
        t = torch.view_as_real(t).reshape(-1)
    return t.view(torch.uint8)


def replay_diffs(outs_a, outs_b) -> list[str]:
    """The output leaves of two runs that differ in any bit."""
    diffs = []
    for step, (a, b) in enumerate(zip(outs_a, outs_b, strict=True)):
        for (name, u), (_, v) in zip(named_leaves(a), named_leaves(b),
                                     strict=True):
            if u.dtype != v.dtype or u.shape != v.shape \
                    or not torch.equal(raw_bits(u), raw_bits(v)):
                diffs.append(f"step {step} {name}")
    return diffs


def in_thread(fn, args) -> tuple[threading.Thread, dict]:
    box = {}
    t = threading.Thread(target=lambda: box.update(rc=fn(args)), daemon=True)
    t.start()
    return t, box


def bound_port(err: io.StringIO, t: threading.Thread, what: str,
               timeout: float = 60.0) -> int:
    """The UDP port that an app started with --port 0 in thread `t` names
    on stderr (captured in `err`) once its socket is bound."""
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline and t.is_alive():
        m = re.search(r"on udp port (\d+)", err.getvalue())
        if m:
            return int(m.group(1))
        time.sleep(0.01)
    raise AssertionError(f"{what}: no bound port announced; stderr "
                         f"{err.getvalue()!r}")


def chat_on_card(dev, counts: collections.Counter) -> None:
    """ofdm_chat listen (a thread) and send, both on the card, over
    loopback UDP: both messages arrive; listen launches sc_detect and
    gather."""
    reset_launches("sc_detect", "gather")
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        t, box = in_thread(ofdm_chat.main, [
            "listen", "--port", "0", "--messages", "2", "--timeout",
            "30", "--block-size", "8192", "--device", str(dev)])
        port = bound_port(err, t, "ofdm_chat listen")
        args = ["send", "--remote-host", "127.0.0.1", "--port", str(port),
                "--device", str(dev)]
        for m in CHAT_MSGS:
            args += ["-m", m]
        rc = ofdm_chat.main(args)
        t.join(60)
    lines = [s for s in out.getvalue().splitlines() if s.startswith("[")]
    if rc != 0 or t.is_alive() or box.get("rc") != 0 \
            or lines != [f"[{i}] {m}" for i, m in enumerate(CHAT_MSGS)]:
        raise AssertionError(f"ofdm_chat: send rc {rc}, listen {box}, "
                             f"printed {lines}")
    counts.update(read_launches("ofdm_chat listen", "sc_detect", "gather"))
    log(f"  ofdm_chat on the card: {lines}")


def analyzer_on_card(dev, counts: collections.Counter) -> None:
    """spectrum_analyzer local on the card (tone 0.25, fft 1024, the
    default blackman_harris): its spectra peak at the tone's bin, one psd
    launch a push; then the same worker with the remote app receiving 3
    frames."""
    local = ["local", "--tone", "0.25", "--fft-len", "1024", "--block-size",
             str(ANALYZER_BLOCK), "--blocks", str(ANALYZER_PUSHES),
             "--frame-rate", "100000", "--device", str(dev)]
    sub = SpectrumSubscriber(bind_port=0)
    reset_launches("psd")
    try:
        rc, _ = quiet(spectrum_analyzer.main, local + ["--port", str(sub.port)])
        frames = [sub.receive(timeout=5.0) for _ in range(3)]
    finally:
        sub.close()
    launches = read_launches("spectrum_analyzer local", "psd")
    peaks = [int(np.argmax(fr.avg_db)) for fr in frames if fr is not None]
    if rc != 0 or peaks != [ANALYZER_TONE_BIN] * 3 \
            or launches["psd"] != ANALYZER_PUSHES:
        raise AssertionError(f"spectrum_analyzer local: rc {rc}, peak bins "
                             f"{peaks}, {launches} in {ANALYZER_PUSHES} "
                             "pushes")
    counts.update(launches)

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        t, box = in_thread(spectrum_analyzer.main, [
            "remote", "--port", "0", "--frames", "3", "--timeout", "20",
            "--width", "64"])
        port = bound_port(err, t, "spectrum_analyzer remote")
        reset_launches("psd")
        rc = spectrum_analyzer.main(local + ["--port", str(port)])
        t.join(30)
    launches = read_launches("spectrum_analyzer local -> remote", "psd")
    lines = [s for s in out.getvalue().splitlines() if "MHz" in s]
    if rc != 0 or t.is_alive() or box.get("rc") != 0 or len(lines) != 3 \
            or launches["psd"] != ANALYZER_PUSHES:
        raise AssertionError(f"spectrum_analyzer remote: local rc {rc}, "
                             f"remote {box}, printed {lines}, {launches} in "
                             f"{ANALYZER_PUSHES} pushes")
    counts.update(launches)
    log(f"  spectrum_analyzer local -> remote on the card: peak bins {peaks},"
        f" one psd launch a push; remote printed {lines[0]!r}")


PORT_SYMBOL = {"sc_detect": re.compile(r"\(anonymous namespace\)::sc_detect"),
               "gather": re.compile(r"\(anonymous namespace\)::gather_kernel")}


def traced_ingest(paths: dict, dev, tmp: pathlib.Path) -> dict:
    """metrics.trace around a fresh feed and INGEST_TRACED ingest pushes:
    the Chrome trace names the port's sc_detect and gather kernels, and its
    host-to-card copies of the feed's pinned planes give the H2D ms and
    GB/s a block (none on the CPU)."""
    ex = ingest_executor(dev)
    ex.push(torch.zeros(BLOCK, dtype=torch.complex64, device=dev))  # warm-up
    with capture_streamer(paths) as fs, metrics.trace(str(tmp / "trace")):
        feed = DeviceFeed(fs.packed(), depth=INGEST_DEPTH, device=dev)
        blocks = iter(feed)
        for _ in range(INGEST_TRACED):
            ex.push(next(blocks))
        feed.close()
    metrics.drain()
    events = json.loads((tmp / "trace" / metrics.TRACE_FILE).read_text())
    events = events["traceEvents"]
    names = {e.get("name", "") for e in events}
    found = {k: sorted(n for n in names if rx.search(n))
             for k, rx in PORT_SYMBOL.items()}
    stages = {metrics.PROFILER_PREFIX + n for n in TRACED_STAGES}
    if not all(found.values()) or not stages <= names:
        raise AssertionError(f"metrics.trace: port kernels or stages not in "
                             f"the trace: {found}, {sorted(stages - names)}")
    log(f"  metrics.trace over {INGEST_TRACED} ingest pushes names "
        f"{[n for v in found.values() for n in v]} and the stages "
        f"{sorted(stages)}")
    nbytes = 2 * BLOCK * 4
    us = [e["dur"] for e in events if "HtoD" in e.get("name", "")
          and e.get("args", {}).get("bytes") == nbytes]
    if not us:
        if dev.type == "cuda":
            raise AssertionError("metrics.trace: no host-to-card copy of a "
                                 "feed block in the trace")
        return {"copies": 0}
    h2d = {"copies": len(us), "ms": sum(us) / len(us) / 1e3,
           "min_ms": min(us) / 1e3, "max_ms": max(us) / 1e3,
           "gb_per_s": nbytes * len(us) / sum(us) / 1e3}
    log(f"  H2D (trace): {h2d['copies']} copies of {nbytes >> 20} MiB, "
        f"{h2d['ms']:.4f} ms a block ({h2d['min_ms']:.4f}-"
        f"{h2d['max_ms']:.4f}), {h2d['gb_per_s']:.2f} GB/s")
    return h2d


def phase_ingest(dev, tag: str, main_rate: float) -> dict:
    """The headline stream read from a capture file: FileStreamer (native)
    -> DeviceFeed (pinned, copy stream) -> StreamExecutor; checkpoint and
    resume across a frame on the cut; a dropped block; a replay; the chat
    and analyzer apps on the card; a trace."""
    if not runtime.NATIVE:
        raise AssertionError("ingest: the native runtime did not load")
    spec = HEADLINE.spec
    H = history_len(spec)
    want = ingest_expected(spec)
    counts = collections.Counter()
    with tempfile.TemporaryDirectory() as d:
        tmp = pathlib.Path(d)
        t0 = time.perf_counter()
        paths = write_capture(spec, dev, tmp)
        log(f"ingest: wrote {INGEST_BLOCKS} blocks of 2^{BLOCK.bit_length() - 1}"
            f" i16c samples "
            f"({INGEST_BLOCKS * BLOCK * 4 >> 20} MiB) and one f32c block in "
            f"{time.perf_counter() - t0:.2f} s; native runtime")

        # (b) uninterrupted, watched, timed
        pc, link = PerfCounters(), LinkMetrics()
        ex = ingest_executor(dev)
        reset_launches("sc_detect", "gather")
        metrics.drain()
        was_on = metrics.enable(True)
        try:
            with capture_streamer(paths) as fs, \
                    Watchdog(lambda: ex.samples_in, WATCHDOG_S) as wd:
                reads = TimedReads(fs)
                outs_b, dt, feed, times = ingest_run(reads, ex, dev, pc,
                                                     sync_push=1)
        finally:
            metrics.enable(was_on)
        spans = metrics.summary(metrics.drain().spans)
        launches = read_launches("ingest", "sc_detect", "gather")
        pushes = INGEST_BLOCKS + 1
        if set(launches.values()) != {pushes} or wd.stall_count:
            raise AssertionError(f"ingest: {launches} launches in {pushes} "
                                 f"pushes, {wd.stall_count} stalls")
        counts.update(launches)
        frames_b = collect_frames(outs_b, block_size=BLOCK, hist=H)
        check_ingest_frames(spec, frames_b, want, "ingest")
        link.update_from_frames(frames_b)
        link.add_samples(INGEST_BLOCKS * BLOCK)
        report = {name: {k: round(v, 3) for k, v in d.items()}
                  for name, d in spans.items()}
        stages = {"read": block_ms([r for r, _ in reads.times]),
                  "convert": block_ms([c for _, c in reads.times]),
                  "feed": block_ms(times["feed"][:INGEST_BLOCKS]),
                  "push": block_ms(times["push"])}
        sps = INGEST_BLOCKS * BLOCK / dt
        log(f"ingest: {len(frames_b)}/{len(want)} frames (the one across "
            f"the seam before block {INGEST_SEAM} included), payload + "
            f"crc_ok + start all good; one sc_detect and one gather a push; "
            f"push 1 under sync debug 'error'; watchdog stalls 0")
        log(f"ingest: {sps / 1e6:.1f} Msamples/s from the i16c file beside "
            f"phase 4's pre-staged {main_rate:.1f}  [{tag}]")
        log("ingest: host ms a block (block 0; mean, min-max of blocks 1-"
            f"{INGEST_BLOCKS - 1}): " + "; ".join(
                f"{k} {v['first']:.3f}; {v['mean']:.3f}, {v['min']:.3f}-"
                f"{v['max']:.3f}" for k, v in stages.items())
            + " (read: the wait for the reader thread's bytes; convert: "
            "i16c into the pinned planes; feed: the consumer's wait for a "
            "staged block; push: its enqueue)")
        log(f"ingest: spans (calls; host ms: total, self, mean) "
            f"{json.dumps(report)}; stages (EWMA) {pc.report_json()}")
        log(f"ingest: link {json.dumps(link.summary())}")
        del feed, ex

        # the f32c block through the feed, against the block staged directly
        with capture_streamer(paths, "f32c") as fs:
            (got,) = list(DeviceFeed(fs.packed(), device=dev))
        if not torch.equal(raw_bits(got), raw_bits(ingest_block(spec, 0, dev))):
            raise AssertionError("ingest: the f32c block differs from the "
                                 "block staged directly")
        log("ingest: the f32c block through the feed equals the staged "
            "block bit for bit")
        del got

        # (c) checkpoint after INGEST_CUT blocks, resume in a fresh executor
        ck = str(tmp / "ckpt")
        with capture_streamer(paths) as fs:
            ex = ingest_executor(dev)
            feed = DeviceFeed(fs.packed(), depth=INGEST_DEPTH, device=dev)
            outs_a = [ex.push(x) for _, x in zip(range(INGEST_CUT), feed)]
            save_state(ck, ex, meta={"capture": "capture.i16c"})
            feed.close()
            del ex, feed
        ex = ingest_executor(dev)
        meta = load_state(ck, ex)
        if resume_step(meta) != INGEST_CUT:
            raise AssertionError(f"resume_step {resume_step(meta)}")
        with capture_streamer(paths) as fs:
            outs_c, _, feed, _ = ingest_run(
                itertools.islice(fs, INGEST_CUT, None), ex, dev, PerfCounters())
        resumed = collect_frames(outs_a + outs_c, block_size=BLOCK, hist=H)
        if sorted(map(frame_key, resumed)) != sorted(map(frame_key, frames_b)):
            raise AssertionError("resume: the frames differ from the "
                                 "uninterrupted run's")
        seam = [f for f in resumed if f["frame_num"] == 1]
        log(f"resume: checkpoint after block {INGEST_CUT - 1}, resumed at "
            f"step {resume_step(meta)}: {len(resumed)} frames equal the "
            f"uninterrupted run's, the frame across the cut once "
            f"(abs_start {seam[0]['abs_start']})")
        del ex, feed, outs_a, outs_c

        # (d) a dropped block loses only the frames that touch it
        flen = len(golden_frame(spec))
        lo, hi = INGEST_DROP * BLOCK, (INGEST_DROP + 1) * BLOCK
        want_d = [(p - BLOCK if p >= hi else p, n) for p, n in want
                  if not (p < hi and p + flen > lo)]
        ex = ingest_executor(dev)
        with capture_streamer(paths) as fs:
            outs_d, _, feed, _ = ingest_run(inject_faults(fs, drop=[INGEST_DROP]),
                                         ex, dev, PerfCounters())
        check_ingest_frames(spec, collect_frames(outs_d, BLOCK, H), want_d,
                            "dropped block")
        log(f"faults: block {INGEST_DROP} dropped: {len(want) - len(want_d)} "
            f"frames lost, the other {len(want_d)} back")
        del ex, feed, outs_d

        # (e) replay: the same frames and the same bits
        ex = ingest_executor(dev)
        with capture_streamer(paths) as fs:
            outs_e, _, feed, _ = ingest_run(fs.packed(), ex, dev, PerfCounters())
        frames_e = collect_frames(outs_e, BLOCK, H)
        diffs = replay_diffs(outs_b, outs_e)
        if sorted(map(frame_key, frames_e)) != sorted(map(frame_key, frames_b)) \
                or diffs:
            raise AssertionError(f"replay: {len(diffs)} leaves differ, "
                                 f"first {diffs[:5]}")
        n_leaves = len(list(named_leaves(outs_e[0])))
        log(f"replay: same frames; all {n_leaves} output leaves of all "
            f"{len(outs_e)} steps bit-identical")
        del ex, feed, outs_b, outs_e

        # (f) the apps on the card, and a trace
        chat_on_card(dev, counts)
        analyzer_on_card(dev, counts)
        h2d = traced_ingest(paths, dev, tmp)
    log(f"ingest: launches over the phase {dict(counts)}")
    return {"launches": dict(counts), "msamples_per_s": sps / 1e6,
            "stages_ms": stages, "h2d": h2d}


# -- 12. the multi-device layer on repeated-device meshes --------------------

SHARD_T = 4              # (a) time shards of the headline stream, 1 x 4
SHARD_K = 120            # slots a shard: 448 frames a block over 4 shards
SHARD_BLOCKS = 4         # staged blocks, then one drain push
SHARD_TIMED = 8          # pushes a timing window
C5_CHANS = 512           # (b) BASELINE config 5 (bench/scaling.py's shape)
C5_MESH = (4, 2)
C5_TAPS = 8              # taps an arm
C5_S = BLOCK // C5_CHANS // C5_MESH[1]   # per channel, per time shard
C5_K = 4
C5_CHUNKS = 4            # chunks with frames, then one drain push
C5_CUT = 2               # checkpoint after chunks 0 .. C5_CUT - 1
C5_ACTIVE = tuple(range(5, C5_CHANS, C5_CHANS // 32))   # 8 a channel shard
C5_SLACK = 40            # group delay of the two filterbanks (test_wideband)
C5_MID = 9000            # per-channel offset of a mid-shard frame
MESH_ANALYZER = ["--tone", "0.25", "--noise", "0.01", "--n-chan", "16",
                 "--chan-fft-len", "32", "--block-size", str(1 << 20),
                 "--blocks", "8", "--frame-rate", "100000", "--mesh", "2x2",
                 "--center-freq", "1e6", "--sample-rate", "4e6"]
MESH_ANALYZER_BIN = 384  # 0.75 of the 16 x 32 full-band bins


def busy_union(spans) -> float:
    """Total length of the union of (start, end) intervals."""
    busy, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy


def chunk_times(push, inputs, n: int = SHARD_TIMED) -> dict:
    """Wall ms a chunk over n pushes (host clock, ended by a synchronize)
    and device busy ms a chunk (the union of the card's kernel, copy and
    set intervals in a torch.profiler trace of len(inputs) pushes)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(n):
        push(inputs[i % len(inputs)])
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / n * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for x in inputs:
            push(x)
        torch.cuda.synchronize()
    spans = [(e.time_range.start, e.time_range.end) for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    return {"wall_ms": wall, "busy_ms": busy_union(spans) / 1e3 / len(inputs)}


PLAIN = {"sc_detect": kdetect.sc_detect_rows_plain,
         "gather": kgather.gather_windows_plain,
         "pfb": kpfb.channelize_fused_plain, "psd": kpsd.psd_fused_plain}


def _cloned(v):
    return v.clone() if isinstance(v, torch.Tensor) else v


@contextlib.contextmanager
def shard_inputs(*names, call: int = 1):
    """Inside the block, record the arguments (tensors cloned) of call
    number `call` of each named kernel wrapper -- call 1 is the second
    shard's, the first whose halo comes from a neighbour.  A stand-in takes
    the wrapper's place under every name the port's modules bind it to and
    calls it; the launches it counts go on to the wrapper's count.  Yields
    {name: (args, kwargs)}."""
    seen, calls, swaps = {}, collections.Counter(), []

    def stand_in(name, fn):
        def spy(*a, **kw):
            if calls[name] == call:
                # `out` (the buffer a replayed step has the kernel write
                # into) is not an input
                seen[name] = (tuple(map(_cloned, a)),
                              {k: _cloned(v) for k, v in kw.items()
                               if k != "out"})
            calls[name] += 1
            try:
                return fn(*a, **kw)
            finally:
                fn.launches += spy.launches
                spy.launches = 0
        spy.launches = 0
        if hasattr(fn, "forms"):      # sc_detect's counts by kernel form
            spy.forms = fn.forms
        return spy

    for name in names:
        fn = WRAPPERS[name]
        spy = stand_in(name, fn)
        for mod in list(sys.modules.values()):
            if getattr(mod, "__name__", "").startswith("tpu_ofdm_torch."):
                for attr in [k for k, v in vars(mod).items() if v is fn]:
                    swaps.append((mod, attr, fn))
                    setattr(mod, attr, spy)
    try:
        yield seen
    finally:
        for mod, attr, fn in swaps:
            setattr(mod, attr, fn)
    if set(seen) != set(names):
        raise AssertionError(f"no call {call} of {set(names) - set(seen)}")


def check_shard_inputs(seen: dict, what: str) -> dict:
    """Each kernel against its plain version on the inputs one shard of the
    path gave it, at phase 3's bars: sc_detect by compare_rows (P and R at
    the inputs' scale), gather bit for bit, pfb within 2e-4 * max, psd
    within 1e-4 * max and bin by bin against the float64 PSD
    (check_psd_witness: the analyzer's tone puts float32 past
    check_power's bar).  Returns each kernel's max abs error."""
    errs = {}
    for name, (a, kw) in seen.items():
        got = WRAPPERS[name](*a, **kw)
        want = PLAIN[name](*a, **kw)
        shapes = ", ".join(str(tuple(v.shape)) for v in (*a, *kw.values())
                           if isinstance(v, torch.Tensor))
        label = f"{what}: {name} on a shard's inputs {shapes}"
        if name == "sc_detect":
            # the inputs' peak over that of phase 3's frames (golden frames
            # over weak noise); config 5's frames are n_chan times stronger
            # and the channelizer adds its gain
            peak = max(a[0].abs().max().item(), kw["head"].abs().max().item())
            unit = max(1.0, peak / float(np.abs(golden_frame(
                HEADLINE.spec)).max()))
            errs[name] = compare_rows(got, want, label, unit)
        elif name == "gather":
            if not torch.equal(got, want):
                raise AssertionError(f"{label}: kernel differs from plain")
            errs[name] = 0.0
            log(f"  {label}: exact")
        elif name == "pfb":
            errs[name] = check_close(got, want, 2e-4, label)
        else:
            errs[name] = check_close(got, want, 1e-4, label)
            check_psd_witness(got, want, psd_witness(*a, **kw), label)
    return errs


def psd_witness(x, fft_len: int, window: str = "hann") -> torch.Tensor:
    """The plain PSD of x's frames in float64."""
    wv, norm = kpsd.window_norm(fft_len, window)
    nf = x.shape[-1] // fft_len
    frames = x[..., : nf * fft_len].reshape(*x.shape[:-1], nf, fft_len)
    y = torch.fft.fft(frames.to(torch.complex128) * torch.as_tensor(
        wv / np.sqrt(norm), device=x.device))
    return y.real ** 2 + y.imag ** 2


def check_psd_witness(got, want, exact, what: str) -> None:
    """Bin by bin against the float64 PSD, at check_power's bar, or, where
    float32 rounding puts the plain version itself past that bar (a tone
    far over the noise floor spreads its rounding into every bin), within
    1.25 times the plain version's own distance from it."""
    own, floor = power_ratio(want, exact)
    ratio, _ = power_ratio(got, exact)
    if not ratio <= max(1.0, 1.25 * own):
        raise AssertionError(f"{what}: a bin is off the float64 PSD by "
                             f"{ratio:.3g} x check_power's bar, the plain "
                             f"version by {own:.3g} x")
    log(f"  {what}: worst bin against the float64 PSD at {ratio:.3g} of "
        f"check_power's bar (floor {floor:.3g}), the plain version at "
        f"{own:.3g}")


def launches_per_push(what: str, names, pushes: int, per_push: int) -> dict:
    launches = read_launches(what, *names)
    if set(launches.values()) != {pushes * per_push}:
        raise AssertionError(f"{what}: {launches} launches in {pushes} "
                             f"pushes, want {per_push} each a push")
    return launches


def shard_headline(dev, counts: collections.Counter) -> dict:
    """(a) phase 4's stream on a 1 x SHARD_T mesh of this card."""
    spec = HEADLINE.spec
    H = history_len(spec)
    S = BLOCK // SHARD_T
    blocks, pos = staged_blocks(spec, SHARD_BLOCKS, dev, seed=0)
    drain = torch.zeros((1, BLOCK), dtype=torch.complex64, device=dev)
    chunks = [blocks[i:i + 1] for i in range(SHARD_BLOCKS)] + [drain]
    mesh = make_mesh(1, SHARD_T, devices=[dev] * SHARD_T)
    ex = StreamExecutor(sharded_rx_stream_block(spec, mesh, 1, S, SHARD_K),
                        BLOCK, device=dev)
    reset_launches("sc_detect", "gather")
    with shard_inputs("sc_detect", "gather") as seen:
        outs = [ex.push(c) for c in chunks]
    launches = launches_per_push("shard 1x4", ("sc_detect", "gather"),
                                 len(chunks), SHARD_T)
    counts.update(launches)
    errs = check_shard_inputs(seen, "shard 1x4")
    del seen
    frames = collect_sharded_stream_frames(outs, S, spec, SHARD_T)
    ref_ex = StreamExecutor(rx_stream_block(spec, StreamConfig(
        block_size=BLOCK, max_frames_per_block=SLOTS)), BLOCK, device=dev)
    ref = collect_frames([ref_ex.push(c[0]) for c in chunks],
                         block_size=BLOCK, hist=H)
    key = lambda f: (f["frame_num"], f["payload"], f["crc_ok"],  # noqa: E731
                     f["abs_start"])
    want = [i * BLOCK + p for i in range(SHARD_BLOCKS) for p in pos]
    got = sorted(f["abs_start"] for f in frames)
    off = np.asarray(got) - np.asarray(want) if len(got) == len(want) else None
    bad = [f for f in frames if f["payload"] != MSG or not f["crc_ok"]
           or f["channel"] != 0]
    if off is None or bad or not np.all((off >= 0) & (off <= spec.cp_len)):
        raise AssertionError(f"shard 1x4: {len(frames)} frames for "
                             f"{len(want)} injected, {len(bad)} bad")
    if sorted(map(key, frames)) != sorted(map(key, ref)):
        raise AssertionError("shard 1x4: frames differ from rx_stream_block's")
    times = chunk_times(ex.push, chunks[:SHARD_BLOCKS])
    log(f"shard (a) 1x{SHARD_T} headline: all {len(frames)} frames once, "
        f"payload + crc_ok + start, equal to rx_stream_block's; "
        f"{SHARD_T} sc_detect and {SHARD_T} gather a push; per "
        f"2^{BLOCK.bit_length() - 1} chunk "
        f"wall {times['wall_ms']:.3f} ms, busy {times['busy_ms']:.3f} ms "
        "(one card stepping through 4 logical shards: not a scaling "
        "figure)")
    return {"frames": len(frames), **times, "errors": errs}


def c5_targets(spec) -> list[tuple[int, int, int, bytes]]:
    """(channel, per-channel start, frame number, payload) of config 5's
    frames: one a chunk on each active channel, by turns mid-shard, across
    the time-shard ownership edge S - H, across the time-shard data edge
    S, and across the chunk boundary (not in the last chunk: the drain
    chunk stays silent)."""
    H = history_len(spec)
    S, Mc = C5_S, C5_MESH[1] * C5_S
    out = []
    for k in range(C5_CHUNKS):
        for j, ch in enumerate(C5_ACTIVE):
            kind = (j + k) % 4
            if kind == 3 and k == C5_CHUNKS - 1:
                kind = 0
            off = [C5_MID + (j % 2) * S, S - H - 200, S - 300, Mc - 400][kind]
            out.append((ch, k * Mc + off, k * len(C5_ACTIVE) + j,
                        f"config5 ch{ch} chunk{k}".encode()))
    return out


def c5_capture(spec, dev) -> torch.Tensor:
    """The config-5 chunks, (C5_CHUNKS + 1) x 2^25 wideband samples: the
    targets' golden frames, times n_chan, through the synthesis filterbank
    over 0.01-rms noise; the last chunk is zeros (the drain)."""
    taps = lowpass_taps(C5_CHANS, taps_per_arm=C5_TAPS)
    bursts = [(ch, p, golden_frame(spec, msg, n) * C5_CHANS)
              for ch, p, n, msg in c5_targets(spec)]
    n = C5_CHUNKS * BLOCK
    wide = torch.zeros((C5_CHUNKS + 1) * BLOCK, dtype=torch.complex64,
                       device=dev)
    wide[:n] = torch.as_tensor(synthesize_bursts(n, C5_CHANS, bursts,
                                                 taps=taps)).to(dev)
    gen = torch.Generator(device=dev).manual_seed(50)
    wide[:n] += torch.view_as_complex(
        torch.randn((n, 2), generator=gen, device=dev) * 0.01)
    return wide.reshape(C5_CHUNKS + 1, BLOCK)


def c5_executor(mesh, dev, S=C5_S, K=C5_K) -> StreamExecutor:
    taps = lowpass_taps(C5_CHANS, taps_per_arm=C5_TAPS)
    return StreamExecutor(sharded_wideband_stream_block(
        WIDEBAND.spec, mesh, C5_CHANS, S, taps=taps, max_frames_per_shard=K),
        BLOCK, device=dev)


def c5_key(f: dict) -> tuple:
    return (f["channel"], f["abs_start"], f["frame_num"], f["payload"],
            f["crc_ok"])


def check_c5_frames(frames, what: str) -> None:
    """Every target once, on its channel, with its payload, frame number,
    crc_ok and a start within C5_SLACK samples."""
    want = {n: (ch, p, msg) for ch, p, n, msg in c5_targets(WIDEBAND.spec)}
    got = {}
    for f in frames:
        if not f["crc_ok"] or f["frame_num"] in got:
            raise AssertionError(f"{what}: a bad or repeated frame {f}")
        got[f["frame_num"]] = f
    if set(got) != set(want):
        raise AssertionError(f"{what}: frames {sorted(set(want) - set(got))} "
                             f"lost, {sorted(set(got) - set(want))} extra")
    for n, (ch, p, msg) in want.items():
        f = got[n]
        if f["channel"] != ch or f["payload"] != msg \
                or abs(f["abs_start"] - p) > C5_SLACK:
            raise AssertionError(f"{what}: frame {n} {f} vs {(ch, p, msg)}")


def shard_config5(dev, counts: collections.Counter) -> tuple[dict, list]:
    """(b) config 5 at 512 channels on a 4x2 mesh of this card."""
    spec = WIDEBAND.spec
    chunks = list(c5_capture(spec, dev))
    n_c, n_t = C5_MESH
    mesh = make_mesh(n_c, n_t, devices=[dev] * (n_c * n_t))
    ex = c5_executor(mesh, dev)
    names = ("pfb", "sc_detect", "gather")
    reset_launches(*names)
    with shard_inputs(*names) as seen:
        outs = [ex.push(c) for c in chunks]
    launches = launches_per_push("shard config 5", names, len(chunks),
                                 n_c * n_t)
    counts.update(launches)
    errs = check_shard_inputs(seen, "config 5 4x2")
    del seen
    frames = collect_sharded_stream_frames(outs, C5_S, spec, n_t)
    check_c5_frames(frames, "config 5 4x2")

    one = c5_executor(make_mesh(1, 1, devices=[dev]), dev, n_t * C5_S, 8)
    f1 = collect_sharded_stream_frames([one.push(c) for c in chunks],
                                       n_t * C5_S, spec, 1)
    wb = StreamExecutor(wideband_rx_block(
        spec, C5_CHANS, StreamConfig(block_size=BLOCK, max_frames_per_block=8),
        taps=lowpass_taps(C5_CHANS, taps_per_arm=C5_TAPS)), BLOCK, device=dev)
    fw = collect_wideband_frames([wb.push(c) for c in chunks], n_t * C5_S,
                                 spec)
    for other, name in ((f1, "1x1"), (fw, "wideband_rx_block(512)")):
        if sorted(map(c5_key, other)) != sorted(map(c5_key, frames)):
            raise AssertionError(f"config 5: the 4x2 frames differ from {name}'s")

    with tempfile.TemporaryDirectory() as d:
        ex1 = c5_executor(mesh, dev)
        outs_a = [ex1.push(c) for c in chunks[:C5_CUT]]
        save_state(d, ex1)
        ex2 = c5_executor(mesh, dev)
        if resume_step(load_state(d, ex2)) != C5_CUT:
            raise AssertionError("config 5: resume step")
        outs_b = [ex2.push(c) for c in chunks[C5_CUT:]]
    resumed = collect_sharded_stream_frames(outs_a + outs_b, C5_S, spec, n_t)
    if sorted(map(c5_key, resumed)) != sorted(map(c5_key, frames)):
        raise AssertionError("config 5: the resumed frames differ")
    times = chunk_times(ex.push, chunks[:C5_CHUNKS])
    log(f"shard (b) config 5, {C5_CHANS} channels on {n_c}x{n_t}: all "
        f"{len(frames)} frames once on their channels (payload, crc_ok, start "
        f"within {C5_SLACK}), equal to the 1x1 mesh's and "
        f"wideband_rx_block({C5_CHANS})'s; checkpoint after chunk "
        f"{C5_CUT - 1} resumed exactly; {n_c * n_t} pfb, sc_detect and "
        f"gather launches a chunk; per 2^{BLOCK.bit_length() - 1} chunk wall "
        f"{times['wall_ms']:.3f} ms, busy {times['busy_ms']:.3f} ms (one "
        f"card stepping through {n_c * n_t} logical shards: not a scaling "
        "figure)")
    return {"frames": len(frames), **times, "errors": errs}, chunks


def shard_nccl(dev, chunk: torch.Tensor) -> None:
    """(c) config 5's first chunk through a world-size-1 NCCL group at 1x1,
    against the local 1x1; the runtime's collectives in that group."""
    with tempfile.TemporaryDirectory() as d:
        shard_dist.initialize(f"file://{d}/rendezvous", 1, 0, device=dev)
        try:
            mesh = shard_dist.global_mesh(1, 1)
            if type(mesh.comm) is not shard_dist.DistComm:
                raise AssertionError("nccl: global_mesh is not distributed")
            a = c5_executor(mesh, dev, 2 * C5_S, 8).push(chunk)
            b = c5_executor(make_mesh(1, 1, devices=[dev]), dev, 2 * C5_S,
                            8).push(chunk)
            diffs = replay_diffs([a], [b])
            if diffs:
                raise AssertionError(f"nccl 1x1 vs local 1x1: {diffs[:5]}")
            stacked = shard_dist.LinkCounters(*(
                torch.full((1,), float(i + 1), device=dev) for i in range(6)))
            m = shard_dist.metrics_from_counters(
                shard_dist.psum_tree(stacked, mesh))
            psd = torch.rand((16, 64), device=dev)
            g = shard_dist.all_gather_spectrum(psd, mesh)
            msg = {"cmd": "retune", "freq": 146.52e6}
            hb = shard_dist.MeshHeartbeat(mesh)
            beats = [hb.beat(1).tolist(), hb.beat(2).tolist()]
            ok = (m["frames_detected"] == 1 and m["samples"] == 6
                  and torch.equal(g, psd)
                  and shard_dist.broadcast_control(msg) == msg
                  and beats == [[1], [2]] and hb.stalled == [])
            if not ok:
                raise AssertionError(f"nccl collectives: {m}, {beats}")
            n_leaves = len(list(named_leaves(a)))
            backend = torch.distributed.get_backend()
        finally:
            torch.distributed.destroy_process_group()
    log(f"shard (c) {backend} world size 1 at 1x1: all {n_leaves} output "
        "leaves bit-identical to the local 1x1; psum_tree, "
        "all_gather_spectrum, broadcast_control and MeshHeartbeat in the "
        "group")


def shard_analyzer(dev, counts: collections.Counter) -> None:
    """(d) spectrum_analyzer mesh on a 2x2 mesh of this card: to a
    SpectrumSubscriber (the tone's bin in each frame), then to the remote
    app over loopback UDP; psd and pfb launched once a shard a step in
    both runs."""
    n_blocks = int(MESH_ANALYZER[MESH_ANALYZER.index("--blocks") + 1])
    mesh = ["mesh", *MESH_ANALYZER, "--device", str(dev), "--port"]

    def run(port: int, what: str):
        reset_launches("psd", "pfb")
        rc = spectrum_analyzer.main(mesh + [str(port)])
        launches = read_launches(what, "psd", "pfb")
        if rc or set(launches.values()) != {4 * n_blocks}:
            raise AssertionError(f"{what}: rc {rc}, {launches} in {n_blocks}"
                                 " steps, want 4 each a step")
        counts.update(launches)

    sub = SpectrumSubscriber(bind_port=0)
    try:
        with shard_inputs("psd", "pfb") as seen:
            run(sub.port, "spectrum_analyzer mesh")
        frames = [sub.receive(timeout=5.0) for _ in range(3)]
    finally:
        sub.close()
    errs = check_shard_inputs(seen, "spectrum_analyzer mesh 2x2")
    peaks = [int(np.argmax(fr.avg_db)) for fr in frames if fr is not None]
    if len(peaks) != 3 or any(abs(p - MESH_ANALYZER_BIN) > 1 for p in peaks):
        raise AssertionError(f"spectrum_analyzer mesh: peak bins {peaks}, "
                             f"want {MESH_ANALYZER_BIN} +- 1")

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        t, box = in_thread(spectrum_analyzer.main, [
            "remote", "--port", "0", "--frames", "3", "--timeout", "20",
            "--width", "64"])
        port = bound_port(err, t, "spectrum_analyzer remote")
        run(port, "spectrum_analyzer mesh -> remote")
        t.join(30)
    lines = [s for s in out.getvalue().splitlines() if "MHz" in s]
    if t.is_alive() or box.get("rc") != 0 or len(lines) != 3:
        raise AssertionError(f"spectrum_analyzer mesh -> remote: remote "
                             f"{box}, printed {lines}")
    log(f"shard (d) spectrum_analyzer mesh 2x2 on the card: peak bins {peaks}"
        f" (want {MESH_ANALYZER_BIN} +- 1), 4 psd and 4 pfb launches a step "
        f"in both runs; remote printed {lines[0]!r}")
    return errs


def phase_shard(dev, tag: str) -> dict:
    """The multi-device layer on meshes that repeat this card."""
    counts = collections.Counter()
    head = shard_headline(dev, counts)
    c5, chunks = shard_config5(dev, counts)
    shard_nccl(dev, chunks[0])
    del chunks
    errs = {}
    for e in (head.pop("errors"), c5.pop("errors"),
              shard_analyzer(dev, counts)):
        for name, err in e.items():
            errs[name] = max(err, errs.get(name, 0.0))
    log(f"shard (e) {dryrun_multichip(8, dev)}")
    log(f"shard: launches over the phase {dict(counts)}; each kernel against"
        f" its plain version on a shard's inputs, max abs err {errs}  [{tag}]")
    return {"launches": dict(counts), "errors": errs,
            "headline_1x4": head, "config5": c5}


# -- 13. BASELINE configs 1-3 -------------------------------------------------

class Baseline(typing.NamedTuple):
    """A BASELINE.json configuration as bench/curves.py:49-68 makes it."""
    name: str
    cfg: OfdmConfig
    cfo: float = 0.0          # subcarriers, from each frame's first sample
    taps: tuple | None = None  # multipath FIR, taps[0] the line of sight
    output: str = "hard"
    radio_snr: float = 25.0   # dB, the loopback's channel (d)


BASELINES = (
    Baseline("config1_bpsk64_awgn",
             OfdmConfig(fft_len=64, cp_len=16, modulation="bpsk",
                        max_payload_bytes=64)),
    Baseline("config2_qpsk256_cfo",
             OfdmConfig(fft_len=256, cp_len=64, modulation="qpsk",
                        max_payload_bytes=256), cfo=1.3),
    # 30 dB in (d): bench/results_curves.json reaches FER 0 at 20 dB
    Baseline("config3_qam16_multipath_soft",
             OfdmConfig(fft_len=64, cp_len=16, modulation="qam16",
                        max_payload_bytes=64),
             taps=(1.0, 0.0, 0.35 + 0.2j, 0.0, 0.1j), output="soft",
             radio_snr=30.0),
)
CONFIG_TIMED = 8         # pushes a trial: phase 4's 24, cut for the time limit
CONFIG_ORACLE = 16       # frames a config through the golden RX (c)
CONFIG_CFO_TOL = 0.02    # int_cfo + fine_cfo against the applied CFO


def baseline_payload(spec, k: int) -> bytes:
    """The largest payload a frame of `spec` carries (max_payload_bytes
    less the CRC32), bytes made from k."""
    return bytes((37 * k + 11 * i) % 256
                 for i in range(spec.max_payload_bytes - 4))


def baseline_frame(bc: Baseline, payload: bytes) -> np.ndarray:
    """The config's golden frame through the golden channel once, in
    float64: the taps, then the CFO from the frame's first sample."""
    spec = bc.cfg.spec
    gp = G.GoldenOfdmParams(fft_len=spec.fft_len, cp_len=spec.cp_len,
                            modulation=spec.modulation)
    taps = None if bc.taps is None else np.asarray(bc.taps, np.complex128)
    frame = G.tx_frame(gp, payload, 0).astype(np.complex128)
    return G.channel(frame, cfo=bc.cfo, fft_len=spec.fft_len,
                     multipath=taps).astype(np.complex64)


def delay_spread(bc: Baseline) -> int:
    return 0 if bc.taps is None else len(bc.taps) - 1


def check_block_on_cpu(bc: Baseline, x, head, what: str):
    """(b) rx_block on [head | x] on the card against the same call on the
    CPU: valid slots, payloads, payload_len, frame_num, crc_ok and int_cfo
    identical, starts within 2, EVM at rtol 1e-3, LLRs at atol 1e-4 times
    their largest magnitude.  Returns the card's result."""
    spec = bc.cfg.spec
    card = rx_block(spec, x, SLOTS, head=head, output=bc.output)
    cpu = rx_block(spec, x.cpu(), SLOTS, head=head.cpu(), output=bc.output)
    v = cpu.valid
    if not torch.equal(card.valid.cpu(), v):
        raise AssertionError(f"{what}: card and CPU disagree on valid slots")
    if int(v.sum()) != FRAMES_PER_BLOCK:
        raise AssertionError(f"{what}: {int(v.sum())} frames on the CPU, "
                             f"want {FRAMES_PER_BLOCK}")
    fc = card.frames
    fh = cpu.frames
    for name in ("payload", "payload_len", "frame_num", "crc_ok", "int_cfo"):
        if not torch.equal(getattr(fc, name).cpu()[v], getattr(fh, name)[v]):
            raise AssertionError(f"{what}: card and CPU disagree on {name}")
    if (card.starts.cpu()[v] - cpu.starts[v]).abs().max() > 2:
        raise AssertionError(f"{what}: starts differ by more than 2")
    torch.testing.assert_close(fc.evm.cpu()[v], fh.evm[v], rtol=1e-3,
                               atol=0, msg=lambda m: f"{what} EVM: {m}")
    llr_err = 0.0
    if bc.output == "soft":
        a, b = fc.llr.cpu()[v], fh.llr[v]
        scale = b.abs().max().item()
        torch.testing.assert_close(a, b, rtol=0, atol=1e-4 * scale,
                                   msg=lambda m: f"{what} LLRs: {m}")
        if not torch.equal(a > 0, b > 0):
            raise AssertionError(f"{what}: LLR signs differ")
        llr_err = (a - b).abs().max().item() / scale
    log(f"  {what}: rx_block card vs CPU on 2^25 + {head.shape[0]}: "
        f"{int(v.sum())} frames agree, fine CFO max diff "
        f"{(card.fine_cfo.cpu()[v] - cpu.fine_cfo[v]).abs().max().item():.3g}"
        + (f", LLRs within {llr_err:.3g} of their max" if llr_err else ""))
    return card


def check_golden_evm(bc: Baseline, x, card, positions, H: int, what: str):
    """(c) the golden RX on the first CONFIG_ORACLE frames of x, each with
    its surroundings: the port's EVM on the card must stay under 2 x the
    golden EVM + 0.02 (tests/test_curves.py:45-46).  Returns both means."""
    spec = bc.cfg.spec
    gp = G.GoldenOfdmParams(fft_len=spec.fft_len, cp_len=spec.cp_len,
                            modulation=spec.modulation)
    v = card.valid.cpu()
    starts = card.starts.cpu()[v].numpy()
    evm = card.frames.evm.cpu()[v].numpy()
    span = spec.max_frame_len + 2 * spec.sym_len
    mine, gold = [], []
    for p in positions[:CONFIG_ORACLE]:
        hit = np.nonzero((starts >= p + H)
                         & (starts <= p + H + spec.cp_len + delay_spread(bc)))
        if len(hit[0]) != 1:
            raise AssertionError(f"{what}: no card frame at {p}")
        mine.append(float(evm[hit[0][0]]))
        lo = max(0, p - 500)
        r = x[lo:p + span].cpu().numpy().astype(np.complex128)
        g = G.rx_frame(gp, r)
        if g is None or not g["crc_ok"]:
            raise AssertionError(f"{what}: the golden RX lost the frame at "
                                 f"{p}")
        gold.append(g["evm"])
    port, ref = float(np.mean(mine)), float(np.mean(gold))
    if not port < 2.0 * ref + 0.02:
        raise AssertionError(f"{what}: EVM {port:.4g} against the golden "
                             f"{ref:.4g}")
    log(f"  {what}: EVM on the card {port:.5f} (mean of "
        f"{len(mine)} frames), golden RX {ref:.5f}; bar {2 * ref + 0.02:.5f}")
    return {"evm": port, "golden_evm": ref}


def gather_yardstick(x, starts, F: int, head, what: str, tag: str) -> dict:
    """gather on the path's windows: the kernel against its plain version
    (bit for bit), warm ms beside the plain version's and the bound; and
    beside x.unfold(-1, F, 1)[starts] on the same windows of x alone."""
    H = 0 if head is None else head.shape[-1]
    got = kgather.gather_windows(x, starts, F, head=head)
    if not torch.equal(got, kgather.gather_windows_plain(x, starts, F,
                                                         head=head)):
        raise AssertionError(f"{what}: kernel differs from plain version")
    ms = cuda_ms(lambda: kgather.gather_windows(x, starts, F, head=head), 50)
    cold = cold_ms(lambda: kgather.gather_windows(x, starts, F, head=head),
                   GATHER_COLD_REPS)
    plain = cuda_ms(lambda: kgather.gather_windows_plain(x, starts, F,
                                                         head=head), 10)
    K = starts.shape[-1]
    b = bound(8 * window_union(starts.cpu().numpy(), F) + 4 * K + 8 * K * F,
              0)
    sx = (starts - H).clamp(0, x.shape[-1] - F).contiguous()
    idx = sx.long()
    if not torch.equal(kgather.gather_windows(x, sx, F),
                       x.unfold(-1, F, 1)[idx]):
        raise AssertionError(f"{what}: kernel differs from x.unfold(...)")
    ms_x = cuda_ms(lambda: kgather.gather_windows(x, sx, F), 50)
    lib = cuda_ms(lambda: x.unfold(-1, F, 1)[idx], 50)
    log(f"  {what}: gather K {K} F {F} exact; kernel {ms:.4f} ms warm "
        f"(its windows fit in the L2), {cold:.4f} cold, plain {plain:.4f}; "
        f"on x alone kernel {ms_x:.4f}, x.unfold(-1, F, 1)[starts] "
        f"{lib:.4f} ms  [{tag}]")
    log_bound(f"{what}: gather K {K} F {F} cold", cold, b)
    return {"F": F, "ms": ms, "cold_ms": cold, "plain_ms": plain, **b,
            "share": b["bound_ms"] / ms, "cold_share": b["bound_ms"] / cold,
            "ms_x": ms_x, "library_ms": lib}


def config_stream(bc: Baseline, k: int, dev, tag: str) -> dict:
    """(a) the streaming RX at the config, then (b), (c) and each kernel
    on (a)'s inputs."""
    spec = bc.cfg.spec
    H = history_len(spec)
    L = spec.fft_len // 2
    slack = delay_spread(bc)
    payload = baseline_payload(spec, k)
    blocks, pos = staged_blocks(spec, 4, dev, seed=30 + k,
                                frame=baseline_frame(bc, payload))
    sc = StreamConfig(block_size=BLOCK, max_frames_per_block=SLOTS)
    ex = StreamExecutor(rx_stream_block(spec, sc, output=bc.output), BLOCK,
                        device=dev)
    res, frames = stream_trials(ex, spec, blocks, pos, payload, CONFIG_TIMED,
                                bc.name, tag, slack)
    form = kdetect.kernel_form(L, spec.cp_len)
    want = {f: 3 * CONFIG_TIMED if f == form else 0 for f in res["forms"]}
    if res["forms"] != want:
        raise AssertionError(f"{bc.name}: sc_detect kernels launched "
                             f"{res['forms']}, want {want}")
    if bc.cfo:
        est = np.asarray([f["int_cfo"] + f["fine_cfo"] for f in frames])
        if not np.all(np.abs(est - bc.cfo) <= CONFIG_CFO_TOL):
            raise AssertionError(f"{bc.name}: CFO estimates {est.min():.4f}"
                                 f" .. {est.max():.4f}, want {bc.cfo}")
        log(f"  {bc.name}: int_cfo + fine_cfo {est.min():.4f} .. "
            f"{est.max():.4f} on {len(est)} frames (CFO {bc.cfo})")
    if bc.output == "soft":
        check_llr_signs(frames, bc.name)
        log(f"  {bc.name}: LLR signs = the wire bits on {len(frames)} frames")

    # the kernels on the exact inputs of (a)'s second push
    ex.reset()
    with shard_inputs("sc_detect", "gather", call=1) as seen:
        ex.push(blocks[0])
        ex.push(blocks[1])
    (x, _, _), kw = seen["sc_detect"]
    head = kw["head"]
    err = check_sc_detect(spec, x, head, [p + H for p in pos],
                          f"{bc.name}: sc_detect ({form}) on [{H} | 2^25]",
                          slack)
    ms = cuda_ms(lambda: kdetect.sc_detect_rows(x, L, spec.cp_len,
                                                head=head), 20)
    plain = cuda_ms(lambda: kdetect.sc_detect_rows_plain(
        x, L, spec.cp_len, head=head), 3)
    b = detect_bound(1, H + BLOCK)
    log(f"  {bc.name}: sc_detect ({form}) at 2^25 + {H}: kernel {ms:.4f} ms,"
        f" plain {plain:.4f} ms  [{tag}]")
    log_bound(f"{bc.name}: sc_detect ({form}) at 2^25 + {H}", ms, b)
    (gx, gstarts, F), gkw = seen["gather"]
    gat = gather_yardstick(gx, gstarts, F, gkw["head"], bc.name, tag)
    card = check_block_on_cpu(bc, x, head, bc.name)
    evm = check_golden_evm(bc, x, card, pos, H, bc.name)
    return {**res, **evm, "errors": {"sc_detect": err, "gather": 0.0},
            "sc_detect": {"form": form, "ms": ms, "plain_ms": plain, **b,
                          "share": b["bound_ms"] / ms},
            "gather": gat}


def config_radio(bc: Baseline, k: int, dev, tag: str) -> dict:
    """(d) ofdm_radio at the config -> channel_block with its impairments
    -> RX one push later: phase 8's loopback and gate."""
    spec = bc.cfg.spec
    inputs, pdus = radio_traffic(spec, dev, seed=93 + k)
    empty = empty_tx_in(spec, SLOTS, dev)
    chan = radio_channel(dev, snr_db=bc.radio_snr, cfo=bc.cfo,
                         fft_len=spec.fft_len, taps=bc.taps)
    ex = radio_executor(dev, spec, output=bc.output)
    radio_trial(ex, chan, inputs, empty, dev)               # warm-up
    names = ("sc_detect", "gather")
    reset_launches(*names)
    dt, outs = radio_trial(ex, chan, inputs, empty, dev)
    pushes = RADIO_PUSHES + RADIO_DRAIN
    launches = launches_per_push(f"{bc.name} radio", names, pushes, 1)
    n = check_loopback(outs, pdus, bc.output == "soft", f"{bc.name} radio",
                       spec)
    sps = pushes * BLOCK / dt
    signs = ", LLR signs = the wire bits" if bc.output == "soft" else ""
    log(f"{bc.name} radio ({bc.radio_snr:g} dB, CFO {bc.cfo}, taps "
        f"{bc.taps}, {bc.output}): {n} of {n} PDUs back once with payload "
        f"and crc_ok{signs}; {dt:.4f} s for {pushes} pushes, "
        f"{sps / 1e6:.1f} Msamples/s per "
        f"direction on {today()}  [{tag}]")
    return {"msamples_per_s": sps / 1e6, "launches": launches}


def phase_configs(dev, tag: str) -> dict:
    """BASELINE configs 1-3 at block 2^25, K 480: (a) the streaming RX,
    (b) a block on the card against the CPU, (c) the golden RX's EVM, (d)
    the radio loopback."""
    counts = collections.Counter()
    errs, runs = {}, {}
    for k, bc in enumerate(BASELINES):
        res = config_stream(bc, k, dev, tag)
        counts.update(res.pop("launches"))
        for name, err in res.pop("errors").items():
            errs[name] = max(err, errs.get(name, 0.0))
        radio = config_radio(bc, k, dev, tag)
        counts.update(radio.pop("launches"))
        runs[bc.name] = {**res, "radio": radio}
        torch.cuda.empty_cache()
    log(f"configs: launches over the phase {dict(counts)}; sc_detect kernels"
        f" by config { {n: r['forms'] for n, r in runs.items()} }  [{tag}]")
    return {"launches": dict(counts), "errors": errs, "configs": runs}


# -- 14. the step's CUDA graphs against the eager step ------------------------

GRAPH_WARM = 2           # pushes before the checked ones: eager, then capture
GRAPH_PUSHES = 6         # checked pushes a path
GRAPH_FIELDS = (*mrx.FrameResult._fields, "starts", "fine_cfo", "valid")


class CheckedSteps:
    """Stands in for rx.STEP_GRAPHS: each call goes to the real one; a
    copy of its result is taken as it returns, and rx_block_eager runs on
    the same arguments.  Keeps (result, copy, eager result) per call."""

    def __init__(self, steps):
        self.steps, self.calls = steps, []

    def run(self, spec, x, *args):
        got = self.steps.run(spec, x, *args)
        copy = [t.clone() for t in mrx._leaves(got)]
        self.calls.append((got, copy, mrx.rx_block_eager(spec, x, *args)))
        return got


def same_bits(a: torch.Tensor, b: torch.Tensor) -> bool:
    return (a.dtype == b.dtype and a.shape == b.shape
            and torch.equal(mrx._bytes(a), mrx._bytes(b)))


def graph_path(what: str, push) -> dict:
    """push(i) enqueues push i of a path.  GRAPH_WARM pushes, then
    GRAPH_PUSHES under CheckedSteps with the counters on; then every
    step's result against the eager one and against its own copy."""
    for i in range(GRAPH_WARM):
        push(i)
    was = metrics.enable(True)
    metrics.drain()
    steps = mrx.STEP_GRAPHS
    checked = mrx.STEP_GRAPHS = CheckedSteps(steps)
    try:
        for i in range(GRAPH_WARM, GRAPH_WARM + GRAPH_PUSHES):
            push(i)
    finally:
        mrx.STEP_GRAPHS = steps
        counters = metrics.drain().counters
        metrics.enable(was)
    frames = 0
    for j, (got, copy, want) in enumerate(checked.calls):
        for name, a, c, w in zip(GRAPH_FIELDS, mrx._leaves(got), copy,
                                 mrx._leaves(want)):
            if not same_bits(a, w):
                raise AssertionError(f"{what}: step {j}: {name} replayed "
                                     "differs from the eager step")
            if not same_bits(a, c):
                raise AssertionError(f"{what}: step {j}: {name} changed "
                                     "after the later pushes")
        frames += int(got.valid.sum())
    replay = counters.get("rx.graph_replay", 0)
    eager = counters.get("rx.graph_eager", 0)
    if not frames or replay != len(checked.calls) or eager:
        raise AssertionError(f"{what}: {len(checked.calls)} steps, {frames} "
                             f"frames, {replay} replayed, {eager} eager")
    log(f"{what}: {len(checked.calls)} consecutive steps ({frames} frames) "
        f"replayed, every output field bit-identical to rx_block_eager and "
        f"unchanged after the later pushes; replay share {replay}/"
        f"{replay + eager}")
    return {"steps": len(checked.calls), "frames": frames,
            "replay": replay, "eager": eager}


SINK_ROUNDS = 3          # rounds of pushes collected at once, a path
SINK_AT_ONCE = 3         # pushes enqueued before each round's one collect


def same_dicts(what: str, got: list[dict], want: list[dict]) -> None:
    """Frame dicts equal key by key, in order, each value of the same type
    and bits (an LLR array of the same dtype and bytes)."""
    if len(got) != len(want):
        raise AssertionError(f"{what}: {len(got)} frames, want {len(want)}")
    for j, (g, w) in enumerate(zip(got, want)):
        if list(g) != list(w):
            raise AssertionError(f"{what}: frame {j}: keys {list(g)}")
        for key, b in w.items():
            a = g[key]
            if isinstance(b, np.ndarray):
                ok = (isinstance(a, np.ndarray) and a.dtype == b.dtype
                      and a.shape == b.shape and a.tobytes() == b.tobytes())
            else:
                ok = type(a) is type(b) and (a == b or (a != a and b != b))
            if not ok:
                raise AssertionError(f"{what}: frame {j}: {key} {a!r}, "
                                     f"want {b!r}")


def sink_path(what: str, push, collect) -> dict:
    """push(i) enqueues push i of a path and returns its step output;
    collect(outs) is the path's sink.  GRAPH_WARM pushes, each collected
    at once; then SINK_ROUNDS rounds of SINK_AT_ONCE pushes under
    CheckedSteps, each round collected in one call with the counters on,
    so that each step is read back after its own event while the later
    pushes are queued.  The dicts must equal those of the eager steps
    (read back field by field), and every step must be read on the
    readback stream ("sink.side")."""
    for i in range(GRAPH_WARM):
        collect([push(i)])
    steps = mrx.STEP_GRAPHS
    checked = mrx.STEP_GRAPHS = CheckedSteps(steps)
    was = metrics.enable(True)
    metrics.drain()
    got, outs = [], []
    try:
        for r in range(SINK_ROUNDS):
            first = GRAPH_WARM + r * SINK_AT_ONCE
            batch = [push(i) for i in range(first, first + SINK_AT_ONCE)]
            got += collect(batch)
            outs += batch
    finally:
        mrx.STEP_GRAPHS = steps
        counters = metrics.drain().counters
        metrics.enable(was)
    if len(checked.calls) != len(outs):
        raise AssertionError(f"{what}: {len(checked.calls)} steps for "
                             f"{len(outs)} pushes")
    want = collect([o._replace(result=eager)
                    for o, (_, _, eager) in zip(outs, checked.calls)])
    same_dicts(what, got, want)
    side = counters.get("sink.side", 0)
    if (not got or side != len(outs) or counters.get("sink.packed") != side
            or "sink.fields" in counters):
        raise AssertionError(f"{what}: {len(outs)} steps, {len(got)} frames,"
                             f" counters {counters}")
    log(f"{what}: {len(outs)} steps collected {SINK_AT_ONCE} at a time "
        f"({len(got)} frames), every dict equal to the eager step's; "
        f"sink.side {side}/{len(outs)}")
    return {"steps": len(outs), "frames": len(got), "side": side}


def phase_graphs(dev, tag: str) -> dict:
    """Phase 14 over the headline stream, configs 1-3, config 4 and the
    radio."""
    sc = StreamConfig(block_size=BLOCK, max_frames_per_block=SLOTS)
    runs = {}

    def stream(what, spec, blocks, sink=False, **options):
        ex = StreamExecutor(rx_stream_block(spec, sc, **options), BLOCK,
                            device=dev)
        runs[what] = graph_path(
            what, lambda i: ex.push(blocks[i % len(blocks)]))
        if sink:
            ex = StreamExecutor(rx_stream_block(spec, sc, **options), BLOCK,
                                device=dev)
            H = history_len(spec)
            runs[f"{what} sink"] = sink_path(
                f"{what} sink", lambda i: ex.push(blocks[i % len(blocks)]),
                lambda outs: collect_frames(outs, BLOCK, H))

    blocks, _ = staged_blocks(HEADLINE.spec, 4, dev, seed=0)
    stream("graphs headline", HEADLINE.spec, blocks, sink=True)
    for k, bc in enumerate(BASELINES):
        spec = bc.cfg.spec
        frame = baseline_frame(bc, baseline_payload(spec, k))
        blocks, _ = staged_blocks(spec, 4, dev, seed=30 + k, frame=frame)
        stream(f"graphs {bc.name}", spec, blocks, output=bc.output,
               sink=bc is BASELINES[1])
        if bc.output == "soft":
            stream(f"graphs {bc.name} simpledfe", spec, blocks,
                   output=bc.output, equalizer="simpledfe")
    del blocks
    torch.cuda.empty_cache()

    block = wideband_capture(dev)
    ex = wideband_executor(dev)
    runs["graphs wideband"] = graph_path("graphs wideband",
                                         lambda i: ex.push(block))
    ex = wideband_executor(dev)
    runs["graphs wideband sink"] = sink_path(
        "graphs wideband sink", lambda i: ex.push(block),
        lambda outs: collect_wideband_frames(outs, BLOCK // WB_CHANS,
                                             WIDEBAND.spec))
    del block, ex
    torch.cuda.empty_cache()

    inputs, _ = radio_traffic(HEADLINE.spec, dev, seed=90)
    for name, options in (("hard", {}), ("soft/simpledfe", dict(
            equalizer="simpledfe", output="soft"))):
        chan = radio_channel(dev)
        ex = radio_executor(dev, **options)
        air = [torch.zeros(BLOCK, dtype=torch.complex64, device=dev)]

        def push(i):
            out = ex.push((inputs[i % len(inputs)], air[0]))
            air[0] = chan.push(out.tx.samples)

        runs[f"graphs radio {name}"] = graph_path(f"graphs radio {name}",
                                                  push)
    torch.cuda.empty_cache()
    log(f"graphs: {sum(r['steps'] for r in runs.values())} steps over "
        f"{len(runs)} paths replayed bit-identical to the eager step, "
        f"{sum(r.get('side', 0) for r in runs.values())} read back after "
        f"their own event  [{tag}]")
    return runs


def main():
    smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    kernels = phase_kernels(dev, smi)
    main_run = phase_main(dev, smi)
    runs = [main_run, phase_wideband(dev, smi),
            phase_spectrum(dev, smi), phase_scan(dev, smi),
            phase_radio(dev, smi), phase_sync(dev, smi),
            phase_flowgraph(dev, smi, main_run["msamples_per_s"]),
            phase_ingest(dev, smi, main_run["msamples_per_s"]),
            phase_shard(dev, smi)]
    configs = phase_configs(dev, smi)
    runs.append(configs)
    phase_graphs(dev, smi)
    report = []
    for name, res in kernels.items():
        source, replaces = SOURCES[name]
        report.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(r["launches"].get(name, 0) for r in runs),
            **res, "share": res["bound_ms"] / res["ms"],
            # phases 12 and 13 also hold the kernels to their plain versions
            "max_abs_err": max([res["max_abs_err"]] + [
                r.get("errors", {}).get(name, 0.0) for r in runs])})
        if name == "sc_detect":
            for form, entry in report[-1]["forms"].items():
                entry["launches"] = FORM_LAUNCHES[form]
        if name in ("sc_detect", "gather"):
            # phase 13: at each BASELINE config's shape, on its inputs
            report[-1]["configs"] = {
                c: {**r[name], **({"launches_by_form": r["forms"]}
                                  if name == "sc_detect" else {})}
                for c, r in configs["configs"].items()}
    log(json.dumps({"kernels": report}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
