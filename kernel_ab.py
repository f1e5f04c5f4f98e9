"""Time the port's sc_detect, gather, scan, sc_metric, psd and pfb kernels
as built from other source trees, in turns with this checkout's, in one
process on one card.

    python3 kernel_ab.py TREE [TREE ...] [--rounds 2] [--out FILE]

Each TREE is a directory holding a `csrc/` of tpu_ofdm_torch with the same C
entry points: an earlier commit's (`git archive <commit>
tpu_ofdm_torch/csrc | tar -x --strip-components=1 -C TREE`), or a variant
of a kernel.  Needs one CUDA card and nvcc; imports no JAX.  Every build is
first held against the plain versions (gather bit for bit, scan at
chip_smoke.py's one-ulp bar, sc_metric at its bars and the gated form bit
for bit against the raw one and the torch gate, psd bin by bin, sc_detect
by compare_rows, pfb against its plain version at 2e-4 of the peak and
its channel-major form bit for bit against its row form transposed; a
tree that fails is reported and timed all the same), then timed in turns, this
checkout first and last in each round (A B .. B A), at the shapes of
chip_smoke.py's `kernels` line:

  detect       sc_detect at fft 64 on [3072 | 2^25] (the headline block)
               and on 128 channels of [1024 | 32768] of config 5's first
               chunk channelized at 512 (its frames ~1e5 over the channel
               noise); at fft 128 / cp 32, 256 / cp 64, 512 / cp 128 and
               1024 / cp 256 (the segment kernel; the any-L kernel in
               trees before it) on chip_smoke.py phase 3's 2^20 buffers of
               golden frames and on [4096 | 2^25] (at fft 256 BASELINE
               config 2's block, phase 13's; the others phase 3's frames
               over a 2^25 block), warm
  gather       K 480, F 2000 over [3072 | 2^25] across the seam, warm and
               cold (chip_smoke.cuda_ms / cold_ms)
  gather_x     the same windows' contiguous form, over the 2^25 block alone
  scan         (1, 2^25) and (3, 2^25)
  metric       sc_metric raw (`sc_metric_launch`) at L 32 on the headline
               block (1, 2^25) and on (4096, 6144) captures, warm and cold
  gate         the gated form (`sc_sync_metric_launch`, gate width 161),
               where the tree has it
  psd          N 1024 on 2^22 samples and N 64 on (64, 2^19) (as 2^25
               samples in one row of frames), through `psd_launch`, warm
               and cold
  pfb          N 64 on 2^25 samples (the wideband step) and N 512 on 2^23
               (the scan), each with a carried tail: the row form
               (`pfb_launch`), the channel-major form (`pfb_chan_launch`,
               where the tree has it) and the row form followed by
               `.t().contiguous()` (the wideband step before the
               channel-major form), warm

Prints one line per build and round, and writes them all as JSON to
--out when it is given.
"""

from __future__ import annotations

import argparse
import json
import pathlib

import numpy as np
import torch

import chip_smoke as cs
from tpu_ofdm_torch.kernels import build
from tpu_ofdm_torch.kernels import gather as kgather
from tpu_ofdm_torch.kernels import pfb as kpfb
from tpu_ofdm_torch.kernels import sc_detect as kdetect
from tpu_ofdm_torch.kernels import psd as kpsd
from tpu_ofdm_torch.kernels import sc_metric as kmetric
from tpu_ofdm_torch.kernels import scan as kscan
from tpu_ofdm_torch.kernels.build import complex_ptr
from tpu_ofdm_torch.modem.rx_stream import history_len
from tpu_ofdm_torch.spectrum.channelizer import (channelize, lowpass_taps,
                                                 polyphase_decompose)


def inputs(dev) -> dict:
    """The timed calls' inputs, shared by every build: {what: (kernel,
    args, plain version)}, where `kernel` is "gather" or "scan"."""
    spec = cs.HEADLINE.spec
    H, F = history_len(spec), spec.max_frame_len
    blocks, _ = cs.staged_blocks(spec, 2, dev, seed=1)
    head, x = blocks[1, -H:].contiguous(), blocks[0]
    starts = cs.headline_starts(H, F, dev)
    starts_x = (starts - H).clamp(0, cs.BLOCK - F).contiguous()
    gen = torch.Generator(device=dev).manual_seed(80)
    x1 = torch.randn((1, cs.BLOCK), generator=gen, device=dev) + 0.25
    x3 = torch.randn((3, cs.BLOCK), generator=gen, device=dev) + 0.25
    r1 = cs.staged_blocks(spec, 1, dev, seed=5)[0][None]
    r2 = cs.metric_captures(4096, 6144, 32, dev)
    p1 = cs.noisy_buffers(1, cs.PSD_BLOCK, seed=22, dev=dev)[0]
    p64 = cs.noisy_buffers(cs.WB_CHANS, cs.BLOCK // cs.WB_CHANS, seed=23,
                           dev=dev)
    c5 = channelize(cs.c5_capture(cs.WIDEBAND.spec, dev)[0], cs.C5_CHANS,
                    lowpass_taps(cs.C5_CHANS, taps_per_arm=cs.C5_TAPS))
    c5 = c5.t()[:cs.C5_CHANS // cs.C5_MESH[0]]
    h5, x5 = c5[:, cs.C5_S - 1024:cs.C5_S].contiguous(), \
        c5[:, cs.C5_S:].contiguous()
    # fft 128 to 1024: phase 3's 2^20 buffers, and [4096 | 2^25]: config
    # 2's block at fft 256, phase 3's frames over a 2^25 block elsewhere
    detect = {}
    for fft_len, cp in DETECT_SPECS:
        spec = cs.OfdmConfig(fft_len=fft_len, cp_len=cp,
                             modulation="qpsk").spec
        b20, _ = cs.detect_buffer(spec, 1 << 20, fft_len, dev)
        detect[f"detect_{fft_len}_2^20"] = (
            "detect", (b20, None, fft_len // 2, cp), None)
        if fft_len == 256:
            c2 = cs.BASELINES[1]
            blocks2, _ = cs.staged_blocks(c2.cfg.spec, 2, dev, seed=31, frame=(
                cs.baseline_frame(c2, cs.baseline_payload(c2.cfg.spec, 1))))
            big = (blocks2[0], blocks2[1, -4096:].contiguous())
            name = "detect_config2"
        else:
            b25, _ = cs.detect_buffer(spec, 4096 + cs.BLOCK, fft_len + 2, dev)
            big = (b25[4096:], b25[:4096].contiguous())
            name = f"detect_{fft_len}_2^25"
        detect[name] = ("detect", (*big, fft_len // 2, cp), None)
    pfb = {}
    for N, n in ((cs.WB_CHANS, cs.BLOCK), (cs.SCAN_CHANS, cs.SCAN_BLOCK)):
        poly = torch.as_tensor(polyphase_decompose(lowpass_taps(N), N),
                               device=dev)
        xp = cs.noisy_buffers(1, n, seed=N + 50, dev=dev)[0]
        tail = xp[-kpfb.tail_len(N, poly.shape[0]):].clone()
        want = kpfb.channelize_fused_plain(xp, poly, tail)
        for form, tag in (("row", ""), ("chan", "_chan"), ("rowt", "_rowt")):
            pfb[f"pfb_{N}{tag}"] = ("pfb", (xp, poly, tail, form), want)
    return {
        "detect_1": ("detect", (x, head, 32, 16), None),
        "detect_c5": ("detect", (x5, h5, 32, 16), None),
        **detect,
        "metric_1": ("metric", (r1, 32), None),
        "metric_4096": ("metric", (r2, 32), None),
        "gate_1": ("gate", (r1, 32), None),
        "gate_4096": ("gate", (r2, 32), None),
        "psd_1024": ("psd", (p1, 1024), None),
        "psd_64": ("psd", (p64, 64), None),
        "gather": ("gather", (x, starts, head, F),
                   kgather.gather_windows_plain(x, starts, F, head)),
        "gather_x": ("gather", (x, starts_x, None, F),
                     kgather.gather_windows_plain(x, starts_x, F)),
        "scan_1": ("scan", (x1,), None),
        "scan_3": ("scan", (x3,), None),
        **pfb,
    }


GATE_W = 2 * cs.HEADLINE.spec.sym_len + 1
# sc_detect's segment-kernel specs (fft_len, cp), timed on 2^20 and 2^25
DETECT_SPECS = [(128, 32), (256, 64), (512, 128), (1024, 256)]


def runner(lib, kernel: str, args):
    """A call of `lib`'s kernel on `args` into an output of its own; None
    where `lib` has no such entry."""
    if kernel == "detect":
        x, head, L, cp = args
        h, n = (0 if head is None else head.shape[-1]), x.shape[-1]
        rows = -(-(h + n) // kdetect.ROW)
        B = x.shape[0] if x.ndim == 2 else 1
        out = torch.empty((6, B, rows), dtype=torch.float32, device=x.device)

        def run():
            lib.launch("sc_detect_launch", x.device, complex_ptr(head), h, h,
                       complex_ptr(x), n, n, B, L, cp, out.data_ptr(), rows)
            o = out.reshape(6, *x.shape[:-1], rows)
            return (o[0], o[1].view(torch.int32), o[2], o[3], o[4], o[5])
    elif kernel in ("metric", "gate"):
        r, L = args
        fn = "sc_metric_launch" if kernel == "metric" else \
            "sc_sync_metric_launch"
        if not hasattr(lib.lib, fn):
            return None
        n = r.shape[-1]
        shape = (*r.shape[:-1], n - 2 * L + 1)
        P = torch.empty(shape, dtype=torch.complex64, device=r.device)
        R = torch.empty(shape, dtype=torch.float32, device=r.device)
        M = torch.empty(shape, dtype=torch.float32, device=r.device)
        extra = () if kernel == "metric" else (kmetric.halo_rows(GATE_W),)

        def run():
            lib.launch(fn, r.device, r.data_ptr(), n, r.numel() // n, L,
                       *extra, P.data_ptr(), R.data_ptr(), M.data_ptr())
            return P, R, M
    elif kernel == "psd":
        x, N = args
        nf = x.numel() // N      # every row a whole number of frames
        out = torch.empty((nf, N), dtype=torch.float32, device=x.device)
        consts = kpsd.device_consts(N, "hann", x.device)

        def run():
            lib.launch("psd_launch", x.device, x.data_ptr(), nf,
                       consts.data_ptr(), N, out.data_ptr())
            return out
    elif kernel == "pfb":
        x, poly, tail, form = args
        fn = "pfb_chan_launch" if form == "chan" else "pfb_launch"
        if not hasattr(lib.lib, fn):
            return None
        J, N = poly.shape
        n = x.shape[0]
        out = torch.empty((N, n // N) if form == "chan" else (n // N, N),
                          dtype=torch.complex64, device=x.device)

        def run():
            lib.launch(fn, x.device, complex_ptr(tail), tail.shape[0],
                       complex_ptr(x), n, poly.data_ptr(), J, N,
                       complex_ptr(out))
            return out.t().contiguous() if form == "rowt" else out
    elif kernel == "gather":
        x, starts, head, F = args
        out = torch.empty((*starts.shape, F), dtype=torch.complex64,
                          device=x.device)

        def run():
            kgather.launch(lib, x, starts, head, out)
            return out
    else:
        (x,) = args
        out = torch.empty_like(x)
        # enough for any tree's tiles of >= 1024 samples
        scratch = torch.empty(4 * x.numel() // 1024 + 64, dtype=torch.float64,
                              device=x.device)

        def run():
            kscan.launch(lib, x, out, scratch)
            return out
    return run


def check(name: str, lib, calls: dict) -> None:
    """Every call of `lib` against its plain version: gather bit for bit,
    scan within chip_smoke.py's one-ulp bar, sc_metric within
    chip_smoke.py's bars and its gated form bit for bit against the raw
    form and the torch gate, psd bin by bin (check_power).  A failure is
    logged, not raised: a rejected design is still timed."""
    bad = []
    for what, (kernel, args, want) in calls.items():
        fn = runner(lib, kernel, args)
        if fn is None:
            continue
        got = fn()
        if kernel == "detect":
            x, head, L, cp = args
            ref = kdetect.sc_detect_rows_plain(x, L, cp, head=head)
            peak = max(x.abs().max().item(),
                       0.0 if head is None else head.abs().max().item())
            unit = max(1.0, peak / float(np.abs(cs.golden_frame(
                cs.HEADLINE.spec)).max()))
            try:
                cs.compare_rows(got, ref, f"{name}: {what}", unit)
                ok = True
            except AssertionError as e:
                cs.log(f"  {name}: {what}: {str(e).splitlines()[0]}")
                ok = False
        elif kernel == "gather":
            ok = torch.equal(got, want)
        elif kernel == "pfb":
            x, poly, tail, form = args
            if form == "row":
                try:
                    cs.check_close(got, want, 2e-4, f"{name}: {what}")
                    ok = True
                except AssertionError as e:
                    cs.log(f"  {e}")
                    ok = False
            else:
                row = runner(lib, kernel, (x, poly, tail, "row"))()
                ok = torch.equal(got, row.t().contiguous())
        elif kernel == "scan":
            ok = cs.scan_ratio(got, args[0])[1] <= 1.0
        elif kernel == "metric":
            worst = cs.metric_ratios(args[0], args[1], got)
            ok = all(w <= 1.0 for w in worst.values())
            cs.log(f"  {name}: {what} worst ratios to the bars {worst}")
        elif kernel == "gate":
            P, R, M = runner(lib, "metric", args)()
            ok = (torch.equal(got[0], P) and torch.equal(got[1], R)
                  and torch.equal(got[2], kmetric.gate_metric(M, R, GATE_W)))
        else:
            x, N = args
            try:
                cs.check_power(got, kpsd.psd_fused_plain(x, N).reshape(-1, N),
                               f"{name}: psd N {N}")
                ok = True
            except AssertionError as e:
                cs.log(f"  {e}")
                ok = False
        if not ok:
            bad.append(what)
    if bad:
        cs.log(f"{name}: FAILS its check on {bad}; timed all the same, as a "
               "design that was tried")
    else:
        cs.log(f"{name}: gather exact, sc_detect, scan, sc_metric, psd and "
               "pfb within their bars, gated sc_metric and pfb's "
               "channel-major form exact where the tree has them")


def timings(lib, calls: dict) -> dict:
    out = {}
    for what, (kernel, args, _) in calls.items():
        fn = runner(lib, kernel, args)
        if fn is None:
            continue
        if kernel in ("gather", "psd"):
            out[what] = cs.cuda_ms(fn, 50)
            out[what + "_cold"] = cs.cold_ms(fn, cs.GATHER_COLD_REPS)
        elif kernel in ("metric", "gate"):
            out[what] = cs.cuda_ms(fn, 20)
            out[what + "_cold"] = cs.cold_ms(fn, 10)
        elif kernel in ("detect", "pfb"):
            out[what] = cs.cuda_ms(fn, 20)
        else:
            out[what] = cs.cuda_ms(fn, 20)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out")
    ap.add_argument("--only", help="comma-separated prefixes of the timed "
                    "calls (detect, gather, scan, metric, gate, psd, pfb); "
                    "default all")
    args = ap.parse_args()
    smi = cs.phase_device()
    dev = torch.device("cuda", 0)
    libs = {"checkout": build.library()}
    for tree in args.trees:
        root = pathlib.Path(tree).resolve()
        libs[tree] = build.build_library(root / "csrc", root / "_build")
    for name, lib in libs.items():
        cs.log(f"{name}: {lib.path}, nvcc {lib.build_seconds:.2f} s")
        lines = lib.build_log.splitlines()
        for i, line in enumerate(lines):
            if "Compiling entry" in line and any(
                    k in line for k in ("sc_detect", "gather", "scan",
                                        "sc_metric", "psd", "pfb")):
                for info in lines[i:i + 4]:
                    cs.log("  ptxas:", info.strip())
    calls = inputs(dev)
    if args.only:
        keep = tuple(args.only.split(","))
        calls = {k: v for k, v in calls.items() if k.startswith(keep)}
    for name, lib in libs.items():
        check(name, lib, calls)
    names = list(libs)
    rows = []
    for rnd in range(args.rounds):
        for name in names + names[::-1]:
            t = timings(libs[name], calls)
            rows.append({"round": rnd, "tree": name, **t})
            cs.log(f"round {rnd} {name}: "
                   + ", ".join(f"{k} {v:.4f}" for k, v in t.items())
                   + f" ms  [{smi}]")
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"device": smi, "rows": rows}, indent=1))
    for name in names:
        mine = [r for r in rows if r["tree"] == name]
        cs.log(f"{name}: " + ", ".join(
            f"{k} {min(r[k] for r in mine):.4f}-{max(r[k] for r in mine):.4f}"
            for k in mine[0] if k not in ("round", "tree")) + " ms")

    cs.log(smi)


if __name__ == "__main__":
    main()
