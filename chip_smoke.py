"""Drive the PyTorch/CUDA port's main path once on one NVIDIA GPU.

    python3 chip_smoke.py

Needs one CUDA card, nvcc, and this checkout; it imports no JAX.  Phases,
in order -- any failure raises and the script exits non-zero:

  1. device   require CUDA; print the card's name and power limit
  2. build    compile the port's CUDA kernels from tpu_ofdm_torch/csrc
  3. kernels  each kernel against its plain PyTorch version on the card, at
              the main path's shapes and on golden frames; kernel and plain
              times; rx_block on the card against rx_block on the CPU
  4. main     streaming RX through StreamExecutor at block 2^25, K = 480,
              fft 64, cp 16, QPSK: 448 golden frames per block, 24 timed
              pushes x 3 trials; every frame must come back with the
              injected payload and crc_ok, and both kernels must have been
              launched by the main path
  5. report   one JSON line of per-kernel results, the nvidia-smi line, and
              the final {"ok": true, ...} line
"""

from __future__ import annotations

import json
import pathlib
import subprocess
import sys
import time

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
from tpu_ofdm_torch.kernels import sc_detect as kdetect
from tpu_ofdm_torch.modem.rx import rx_block
from tpu_ofdm_torch.modem.rx_stream import (collect_frames, history_len,
                                            rx_stream_block)
from tpu_ofdm_torch.ops.sync import _select_from_rows
from tpu_ofdm_torch.stream.executor import StreamExecutor

FRAMES_PER_BLOCK = 448
BLOCK = 1 << 25
SLOTS = 480
N_TIMED = 24
MSG = bytes(range(64)) * 2
HEADLINE = OfdmConfig(fft_len=64, cp_len=16, modulation="qpsk")


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


def cuda_ms(fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    t0 = torch.cuda.Event(enable_timing=True)
    t1 = torch.cuda.Event(enable_timing=True)
    t0.record()
    for _ in range(reps):
        fn()
    t1.record()
    t1.synchronize()
    return t0.elapsed_time(t1) / reps


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

    # gather: K = 480 windows of F = 2000 across the head/x seam
    F = spec.max_frame_len
    nv = H + BLOCK
    seam = [0, 1, H - F - 1, H - F, H - 1000, H - 1, H, H + 1, nv - F - 1,
            nv - F]
    rng = np.random.RandomState(3)
    rand = rng.randint(0, nv - F + 1, SLOTS - len(seam))
    starts = torch.as_tensor(np.sort(np.concatenate([seam, rand])),
                             dtype=torch.int32, device=dev)
    got = kgather.gather_windows(x, starts, F, head=head)
    ref = kgather.gather_windows_plain(x, starts, F, head=head)
    if not torch.equal(got, ref):
        raise AssertionError("gather: kernel differs from plain version")
    log(f"  gather K {SLOTS} F {F} across the seam: exact")
    ms_g = cuda_ms(lambda: kgather.gather_windows(x, starts, F, head=head),
                   50)
    ms_g_plain = cuda_ms(
        lambda: kgather.gather_windows_plain(x, starts, F, head=head), 10)
    log(f"  gather K {SLOTS} F {F}: kernel {ms_g:.4f} ms, plain "
        f"{ms_g_plain:.4f} ms  [{tag}]")

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

    kernels = [
        {"name": "sc_detect", "route": "cuda",
         "source": "tpu_ofdm_torch/csrc/sc_detect.cu",
         "replaces": "tpu_ofdm/kernels/sc_detect.py:327",
         "max_abs_err": err_det, "ms": ms_det, "plain_ms": ms_det_plain},
        {"name": "gather", "route": "cuda",
         "source": "tpu_ofdm_torch/csrc/gather.cu",
         "replaces": "tpu_ofdm/kernels/gather.py:126",
         "max_abs_err": (got - ref).abs().max().item(),
         "ms": ms_g, "plain_ms": ms_g_plain},
    ]
    return kernels


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


def main():
    smi = phase_device()
    dev = torch.device("cuda", 0)
    phase_build()
    kernels = phase_kernels(dev, smi)
    main_res = phase_main(dev, smi)
    for k in kernels:
        k["launches"] = main_res["launches"][k["name"]]
    log(json.dumps({"kernels": kernels}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
