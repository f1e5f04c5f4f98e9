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
              on the CPU.  sc_detect and gather also batched over 64
              channels; gather bit for bit at odd and even F on windows of
              every class and both parities, and timed cold (L2 flushed
              before each launch) and per call from the host beside
              x.unfold(-1, F, 1)[starts]; pfb at 8..512 channels with a
              two-step tail carry; psd at 128, 384 and 1024 bins with two
              windows, bin by bin; pfb and psd also at the shapes the paths
              give them; scan also at ragged lengths and along a leading
              axis, beside float32 and float64 torch.cumsum
  4. main     streaming RX through StreamExecutor at block 2^25, K = 480,
              fft 64, cp 16, QPSK: 448 golden frames per block, 24 timed
              pushes x 3 trials; every frame must come back with the
              injected payload and crc_ok, and both kernels must have been
              launched by the main path
  5. wideband channelizer -> 64 parallel demods (BASELINE config 4) at
              block 2^25, K = 4: 3 frames per push on channels 3, 17, 40,
              4 timed pushes x 3 trials; every push must give exactly those
              frames; pfb, sc_detect and gather must have been launched
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
              vs CPU; sc_metric launched by schmidl_cox; moving_sum on
              2^25 real and complex samples vs float64 window sums, the
              only caller of scan here
 10. report   one JSON line of per-kernel results, the nvidia-smi line, and
              the final {"ok": true, ...} line
"""

from __future__ import annotations

import json
import math
import pathlib
import subprocess
import sys
import time
import zlib

import numpy as np
import torch

# The golden model is loaded by path: an installed third-party package may
# ship a top-level `tests` package that shadows this checkout's tests/.
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "tests"
                       / "golden"))
import golden_ofdm as G  # noqa: E402
from tpu_ofdm_torch.config import OfdmConfig, StreamConfig
from tpu_ofdm_torch.kernels import build
from tpu_ofdm_torch.kernels import gather as kgather
from tpu_ofdm_torch.kernels import pfb as kpfb
from tpu_ofdm_torch.kernels import psd as kpsd
from tpu_ofdm_torch.kernels import sc_detect as kdetect
from tpu_ofdm_torch.kernels import sc_metric as kmetric
from tpu_ofdm_torch.kernels import scan as kscan
from tpu_ofdm_torch.modem.radio import ofdm_radio
from tpu_ofdm_torch.modem.rx import rx_block
from tpu_ofdm_torch.modem.rx_stream import (collect_frames, history_len,
                                            rx_stream_block)
from tpu_ofdm_torch.modem.wideband import (collect_wideband_frames,
                                           wideband_rx_block)
from tpu_ofdm_torch.modem.tx import tx_frame
from tpu_ofdm_torch.modem.tx_stream import TxStreamIn, empty_tx_in
from tpu_ofdm_torch.ops.channel import channel_block
from tpu_ofdm_torch.ops.sync import (_select_from_rows,
                                     coarse_sliding_max_same, moving_sum,
                                     schmidl_cox)
from tpu_ofdm_torch.spectrum import (channelizer_block, log_pwr_fft_block,
                                     spectrum_probe_block, waterfall_block)
from tpu_ofdm_torch.spectrum.channelizer import (lowpass_taps,
                                                 polyphase_decompose,
                                                 synthesize_bursts)
from tpu_ofdm_torch.stream.block import (chain, complex_to_mag_squared,
                                         stateless)
from tpu_ofdm_torch.stream.executor import StreamExecutor

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
            "scan": kscan.cumsum, "sc_metric": kmetric.sc_sliding_metric}

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

def compare_rows(got, ref, what: str) -> float:
    """Kernel rows vs plain rows: >= 99% identical argmax; the other five
    rows at rtol 1e-4 / atol 1e-5 where the argmax agrees.  Returns the max
    abs error over the compared entries."""
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
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5,
                                   msg=lambda s: f"{what} row {i}: {s}")
        err = max(err, (a - b).abs().max().item())
    log(f"  {what}: argmax agrees {frac:.5f}, max abs err {err:.3g}")
    return err


def check_selection(spec, got, ref, nv, positions, what):
    """_select_from_rows on kernel rows and on plain rows must give the
    same detections, and find every injected frame inside its CP."""
    n_sm = nv - spec.fft_len - spec.cp_len + 1
    K = len(positions) + 8
    sel = [_select_from_rows(spec, *rows, n_sm=n_sm, max_frames=K,
                             threshold=spec.cfg.sync_threshold)
           for rows in (got, ref)]
    if not torch.equal(sel[0].valid, sel[1].valid):
        raise AssertionError(f"{what}: selection valid masks differ")
    v = sel[0].valid
    if not torch.equal(sel[0].start[v], sel[1].start[v]):
        raise AssertionError(f"{what}: selected starts differ")
    torch.testing.assert_close(sel[0].fine_cfo[v], sel[1].fine_cfo[v],
                               rtol=1e-3, atol=1e-4)
    starts = sel[0].start[v].cpu().numpy()
    want = np.asarray(positions)
    if len(starts) != len(want) or not np.all(
            (starts >= want) & (starts <= want + spec.cp_len)):
        raise AssertionError(f"{what}: found {len(starts)} frames, "
                             f"want {len(want)} inside their CPs")


def check_sc_detect(spec, x, head, positions, what) -> float:
    L = spec.fft_len // 2
    got = kdetect.sc_detect_rows(x, L, spec.cp_len, head=head)
    ref = kdetect.sc_detect_rows_plain(x, L, spec.cp_len, head=head)
    err = compare_rows(got, ref, what)
    nv = x.shape[0] + (0 if head is None else head.shape[0])
    check_selection(spec, got, ref, nv, positions, what)
    return err


def phase_kernels(dev, tag: str) -> list[dict]:
    log("kernels: CUDA kernel vs plain PyTorch version, on the card")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    # sc_detect on a 2^20-sample buffer with golden frames, both configs,
    # contiguous (h = 0) and split at a 3072-sample head
    n = 1 << 20
    for fft_len, cp in [(64, 16), (256, 64)]:
        spec = OfdmConfig(fft_len=fft_len, cp_len=cp, modulation="qpsk").spec
        frame = golden_frame(spec)
        positions = list(range(1000, n - 2 * len(frame), n // 24))
        buf = noisy_buffers(1, n, seed=fft_len, dev=dev)
        add_frames(buf, frame, positions)
        buf = buf[0]
        for h in (0, 3072):
            head = buf[:h].contiguous() if h else None
            check_sc_detect(spec, buf[h:].contiguous(), head, positions,
                            f"sc_detect fft {fft_len} cp {cp} head {h}")

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
        "sc_detect": {"max_abs_err": max(err_det, err_b_det), "ms": ms_det,
                      "plain_ms": ms_det_plain, **b_det,
                      "library_ms": None},
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


def check_power(got, want, what: str, floor: float | None = None) -> float:
    """Linear power, bin by bin: |got - want| <= 1e-4 * (want + floor),
    where floor is the median of `want` (its noise floor per bin) unless
    given.  Every bin is held to its own size, not to the strongest one's:
    a wrong or empty bin among the noise fails.  Returns the max abs
    error."""
    got, want = got.double(), want.double()
    floor = want.median().item() if floor is None else floor
    err = (got - want).abs()
    ratio = (err / (1e-4 * (want.abs() + floor))).max().item()
    if not ratio <= 1.0:
        raise AssertionError(f"{what}: a bin is off by {ratio:.3g} x its "
                             f"bar 1e-4 * (power + {floor:.3g})")
    e = err.max().item()
    log(f"  {what}: max abs err {e:.3g}, worst bin at {ratio:.3g} of its "
        f"bar (floor {floor:.3g})")
    return e


def check_pfb(dev, tag: str) -> dict:
    """pfb against its plain version at 8..512 channels over 2^20 samples,
    in two steps joined by the tail carry, and at the paths' shapes, on
    noise alone (atol 2e-4 * max|want|, the bar of
    tests/test_kernels_pfb.py); then kernel and plain times at the paths'
    shapes."""
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
        times[N] = (cuda_ms(lambda: kpfb.channelize_fused(x, poly, tail), 20),
                    cuda_ms(lambda: kpfb.channelize_fused_plain(x, poly, tail),
                            3))
        log(f"  pfb N {N} at {n} samples: kernel {times[N][0]:.4f} ms, "
            f"plain {times[N][1]:.4f} ms  [{tag}]")
        J = poly.shape[0]
        # x in and out, the FIR's lookback in the tail, the taps; a complex
        # times real multiply-add per tap, ~5 log2 N flops of FFT
        bounds[N] = bound(16 * n + 8 * (J - 1) * N + 4 * J * N,
                          n * (4 * J + 5 * math.log2(N)))
        log_bound(f"pfb N {N} at {n} samples", times[N][0], bounds[N])
    return {"max_abs_err": err, "ms": times[WB_CHANS][0],
            "plain_ms": times[WB_CHANS][1], **bounds[WB_CHANS],
            "library_ms": None}


def check_psd(dev, tag: str) -> dict:
    """psd against its plain version on noise alone, at 128, 384 and 1024
    bins with two windows and at the spectrum path's shapes: within
    1e-4 * max (the bar of tests/test_kernels_psd.py), and bin by bin
    (check_power); then kernel and plain times at the path's shapes."""
    err = 0.0
    x = noisy_buffers(1, 1 << 20, seed=21, dev=dev)[0]
    cases = [(x, "2^20", N, window) for N in (128, 384, 1024)
             for window in ("hann", "blackman_harris")]
    x = noisy_buffers(1, PSD_BLOCK, seed=22, dev=dev)[0]
    cases += [(x, "2^22", 1024, "blackman_harris"), (x, "2^22", 1024, "hann"),
              (x, "2^22", 512, "hann")]
    for xs, size, N, window in cases:
        got = kpsd.psd_fused(xs, N, window)
        want = kpsd.psd_fused_plain(xs, N, window)
        what = f"psd N {N} {window} over {size}"
        err = max(err, check_close(got, want, 1e-4, what),
                  check_power(got, want, what))
    times = {}
    for N in (1024, 512):
        times[N] = (cuda_ms(lambda: kpsd.psd_fused(x, N), 50),
                    cuda_ms(lambda: kpsd.psd_fused_plain(x, N), 10))
        log(f"  psd N {N} at 2^22 samples: kernel {times[N][0]:.4f} ms, "
            f"plain {times[N][1]:.4f} ms  [{tag}]")
    # 8 bytes in and 4 out per sample, the window; window product, FFT and
    # |.|^2 flops
    b = bound(12 * PSD_BLOCK + 4 * 1024, PSD_BLOCK * (5 + 5 * 10))
    log_bound("psd N 1024 at 2^22 samples", times[1024][0], b)
    return {"max_abs_err": err, "ms": times[1024][0],
            "plain_ms": times[1024][1], **b, "library_ms": None}


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


def check_sc_metric(dev, tag: str) -> dict:
    """sc_sliding_metric against its float64 plain version at L 32 on the
    headline block (448 golden frames over noise, 2^25) and on (4096, 6144)
    captures, and at L 128 and 192 on (2, 2^20).  Bars relative to the
    window pair's energy E = R1 + R2 (|P| <= E / 2): |dP|, |dR| <= 1e-5 E,
    and |dM| <= 1e-4 (E/R) (E/R + 2M), what those bars allow M with a 10x
    margin.  Then kernel and plain times."""
    err = 0.0
    times = {}
    spec = HEADLINE.spec
    frame = golden_frame(spec)
    for L, shape in METRIC_CASES:
        if shape[1] == BLOCK:
            r = staged_blocks(spec, 1, dev, seed=5)[0]
        else:
            r = noisy_buffers(shape[0], shape[1], seed=L + shape[0], dev=dev)
            add_frames(r, frame, list(range(1024, shape[1] - len(frame),
                                            max(shape[1] // 8,
                                                len(frame) + 7))))
        P, R, M = kmetric.sc_sliding_metric(r, L)
        Pw, Rw, Mw = kmetric.sc_sliding_metric_plain(r, L)
        E = pair_energy(r, L)
        q = E / Rw.double()
        bars = {"P": (P - Pw).abs().double() / (1e-5 * E),
                "R": (R - Rw).abs().double() / (1e-5 * E),
                "M": (M - Mw).abs().double() / (1e-4 * q * (q + 2 * Mw))}
        worst = {k: v.max().item() for k, v in bars.items()}
        if not all(w <= 1.0 for w in worst.values()):
            raise AssertionError(f"sc_metric L {L} {shape}: worst ratios to "
                                 f"the bars {worst}")
        e = max((P - Pw).abs().max().item(), (R - Rw).abs().max().item(),
                (M - Mw).abs().max().item())
        err = max(err, e)
        if L == 32:
            times[shape] = (
                cuda_ms(lambda: kmetric.sc_sliding_metric(r, L), 20),
                cuda_ms(lambda: kmetric.sc_sliding_metric_plain(r, L), 3))
        t = (f"; kernel {times[shape][0]:.4f} ms, plain "
             f"{times[shape][1]:.4f} ms" if L == 32 else "")
        log(f"  sc_metric L {L} {shape}: max abs err {e:.3g}, worst ratio "
            f"to the bars P {worst['P']:.3g} R {worst['R']:.3g} M "
            f"{worst['M']:.3g}{t}  [{tag}]")
    ms, plain_ms = times[METRIC_CASES[0][1]]
    L, shape = METRIC_CASES[0]
    n, nd = math.prod(shape), shape[0] * (shape[1] - 2 * L + 1)
    # 8 bytes in per sample; P (8), R (4) and M (4) out per window pair;
    # ~20 flops per sample
    b = bound(8 * n + 16 * nd, 20 * n)
    log_bound(f"sc_metric L {L} {shape}", ms, b)
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms, **b,
            "library_ms": None}


def tone(n: int, k: int, period: int, dev, amp: float = 1.0) -> torch.Tensor:
    """amp * exp(2 pi i k t / period), t < n, complex64; the phase index is
    reduced mod `period` in integers, so it is exact."""
    idx = (torch.arange(n, device=dev) * k) % period
    ph = idx.to(torch.float32) * (2 * np.pi / period)
    return (amp * torch.polar(torch.ones_like(ph), ph)).to(torch.complex64)


# -- 4. main path --------------------------------------------------------------

def staged_blocks(spec, n_blocks, dev, seed=0):
    """Blocks laid out as bench.py lays them: FRAMES_PER_BLOCK golden frames
    at identical offsets in every block, over noise."""
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
    H = history_len(spec)
    blocks, pos = staged_blocks(spec, 4, dev, seed=0)
    ex = StreamExecutor(rx_stream_block(spec, sc), BLOCK, device=dev)

    def trial():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        outs = [ex.push(blocks[i % len(blocks)]) for i in range(N_TIMED)]
        n_frames = int(torch.stack([o.result.valid.sum() for o in outs])
                       .sum().item())
        return time.perf_counter() - t0, n_frames, outs

    trial()                                   # warm-up
    ex.reset()
    kdetect.sc_detect_rows.launches = 0
    kgather.gather_windows.launches = 0
    results = [trial() for _ in range(3)]
    launches = {"sc_detect": kdetect.sc_detect_rows.launches,
                "gather": kgather.gather_windows.launches}
    log(f"main: launches in the timed run {launches}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"main path never launched {name}")
    # a step must enqueue without waiting on the host: any synchronizing
    # call inside push() raises in this mode
    torch.cuda.set_sync_debug_mode("error")
    try:
        ex.push(blocks[0])
    finally:
        torch.cuda.set_sync_debug_mode("default")
    log("main: one push under sync debug mode 'error': no host sync")

    dt = min(r[0] for r in results)
    n_frames = results[0][1]
    expect = FRAMES_PER_BLOCK * N_TIMED
    tail = -(-H * FRAMES_PER_BLOCK // BLOCK) + 1
    if not expect - tail <= n_frames <= expect:
        raise AssertionError(f"recovered {n_frames} frames, expect {expect}")

    frames = collect_frames(results[0][2], block_size=BLOCK, hist=H)
    want = [i * BLOCK + p for i in range(N_TIMED) for p in pos]
    got = [f["abs_start"] for f in frames]
    bad = [f for f in frames
           if f["payload"] != MSG or not f["crc_ok"] or not f["hdr_ok"]]
    if len(frames) != n_frames or bad:
        raise AssertionError(f"{len(bad)} frames with a wrong payload or "
                             f"CRC, first {bad[:1]}")
    off = np.asarray(got) - np.asarray(want[: len(got)])
    if not np.all((off >= 0) & (off <= spec.cp_len)):
        raise AssertionError("detected starts off their frames' CPs")

    sps = N_TIMED * BLOCK / dt
    log(f"main: {n_frames}/{expect} frames, payload + crc_ok all good; "
        f"trials {[round(r[0], 4) for r in results]} s; "
        f"{sps / 1e6:.1f} Msamples/s  [{tag}]")
    return {"msamples_per_s": sps / 1e6, "frames": n_frames,
            "launches": launches}


def reset_launches(*names):
    for name in names:
        WRAPPERS[name].launches = 0


def read_launches(path: str, *names) -> dict:
    """The launch counts of `names` since reset_launches; raises if a
    kernel of the path was never launched."""
    launches = {name: WRAPPERS[name].launches for name in names}
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
    return chain(channelizer_block(SCAN_CHANS), complex_to_mag_squared(),
                 stateless(lambda x: x.mean(-2)))


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


def check_loopback(outs, pdus, soft: bool, what: str) -> int:
    """Every queued PDU was accepted and came back exactly once, in order,
    with its payload, frame number and crc_ok; with soft output, the LLR
    signs of every frame equal its wire bits (payload + CRC32)."""
    acc = torch.stack([o.tx.accepted for o in outs[:RADIO_PUSHES]]).cpu()
    if not bool(acc[:, :RADIO_PDUS].all()) or bool(acc[:, RADIO_PDUS:].any()):
        raise AssertionError(f"{what}: TX refused a PDU or accepted an "
                             "empty slot")
    frames = collect_frames([o.rx for o in outs], block_size=BLOCK,
                            hist=history_len(HEADLINE.spec))
    want = [(m, (i * RADIO_PDUS + k) % 4096)
            for i, msgs in enumerate(pdus) for k, m in enumerate(msgs)]
    got = [(f["payload"], f["frame_num"]) for f in frames]
    if got != want or not all(f["crc_ok"] for f in frames):
        bad = next((i for i, (a, b) in enumerate(zip(got, want)) if a != b),
                   min(len(got), len(want)))
        raise AssertionError(f"{what}: {len(got)} frames back for "
                             f"{len(want)} PDUs, first mismatch at {bad}")
    if soft:
        for f in frames:
            wire = f["payload"] + zlib.crc32(f["payload"]).to_bytes(4, "little")
            bits = np.unpackbits(np.frombuffer(wire, np.uint8))
            if not np.array_equal(f["llr"] < 0, bits.astype(bool)):
                raise AssertionError(f"{what}: LLR signs differ from the "
                                     f"bits of frame {f['frame_num']}")
    return len(frames)


def radio_executor(dev, **options) -> StreamExecutor:
    """The radio at the headline spec; options go to ofdm_radio."""
    sc = StreamConfig(block_size=BLOCK, max_frames_per_block=SLOTS)
    return StreamExecutor(ofdm_radio(HEADLINE.spec, sc, **options), BLOCK,
                          device=dev)


def radio_channel(dev) -> StreamExecutor:
    return StreamExecutor(channel_block(seed=91, snr_db=RADIO_SNR,
                                        cfo=RADIO_CFO,
                                        fft_len=HEADLINE.spec.fft_len),
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
    log(f"sync: 3 x {SYNC_TRIALS} captures and 2 moving sums of 2^25, with "
        f"the CPU comparisons, in {dt:.4f} s  [{tag}]")
    return {"launches": launches}


def main():
    smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    kernels = phase_kernels(dev, smi)
    runs = [phase_main(dev, smi), phase_wideband(dev, smi),
            phase_spectrum(dev, smi), phase_scan(dev, smi),
            phase_radio(dev, smi), phase_sync(dev, smi)]
    report = []
    for name, res in kernels.items():
        source, replaces = SOURCES[name]
        report.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces,
            "launches": sum(r["launches"].get(name, 0) for r in runs),
            **res, "share": res["bound_ms"] / res["ms"]})
    log(json.dumps({"kernels": report}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
