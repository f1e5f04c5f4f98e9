"""Time the port's gather and scan kernels as built from other source trees,
in turns with this checkout's, in one process on one card.

    python3 kernel_ab.py TREE [TREE ...] [--rounds 2] [--out FILE]

Each TREE is a directory holding a `csrc/` of tpu_ofdm_torch with the same C
entry points: an earlier commit's (`git archive <commit>
tpu_ofdm_torch/csrc | tar -x --strip-components=1 -C TREE`), or a variant
of a kernel.  Needs one CUDA card and nvcc; imports no JAX.  Every build is
first held against the plain versions (gather bit for bit, scan at
chip_smoke.py's one-ulp bar), then timed in turns, this checkout first and
last in each round (A B .. B A), at the shapes of chip_smoke.py's `kernels`
line:

  gather       K 480, F 2000 over [3072 | 2^25] across the seam, warm and
               cold (chip_smoke.cuda_ms / cold_ms)
  gather_x     the same windows' contiguous form, over the 2^25 block alone
  scan         (1, 2^25) and (3, 2^25)

Prints one line per build and round, and writes them all as JSON to
--out when it is given.
"""

from __future__ import annotations

import argparse
import json
import pathlib

import torch

import chip_smoke as cs
from tpu_ofdm_torch.kernels import build
from tpu_ofdm_torch.kernels import gather as kgather
from tpu_ofdm_torch.kernels import scan as kscan
from tpu_ofdm_torch.modem.rx_stream import history_len


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
    return {
        "gather": ("gather", (x, starts, head, F),
                   kgather.gather_windows_plain(x, starts, F, head)),
        "gather_x": ("gather", (x, starts_x, None, F),
                     kgather.gather_windows_plain(x, starts_x, F)),
        "scan_1": ("scan", (x1,), None),
        "scan_3": ("scan", (x3,), None),
    }


def runner(lib, kernel: str, args):
    """A call of `lib`'s kernel on `args` into an output of its own."""
    if kernel == "gather":
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
    scan within chip_smoke.py's one-ulp bar."""
    for what, (kernel, args, want) in calls.items():
        got = runner(lib, kernel, args)()
        ok = (torch.equal(got, want) if kernel == "gather"
              else cs.scan_ratio(got, args[0])[1] <= 1.0)
        if not ok:
            raise AssertionError(f"{name}: {what} differs from the plain "
                                 "version")
    cs.log(f"{name}: gather exact, scan within its bar")


def timings(lib, calls: dict) -> dict:
    out = {}
    for what, (kernel, args, _) in calls.items():
        fn = runner(lib, kernel, args)
        if kernel == "gather":
            out[what] = cs.cuda_ms(fn, 50)
            out[what + "_cold"] = cs.cold_ms(fn, cs.GATHER_COLD_REPS)
        else:
            out[what] = cs.cuda_ms(fn, 20)
    return out


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("trees", nargs="+")
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--out")
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
            if "Compiling entry" in line and ("gather" in line
                                              or "scan" in line):
                for info in lines[i:i + 3]:
                    cs.log("  ptxas:", info.strip())
    calls = inputs(dev)
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
