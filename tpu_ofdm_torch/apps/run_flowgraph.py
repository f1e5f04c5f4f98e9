"""Run a declarative JSON flowgraph spec: the `grcc + top_block.run()`
analog (counterpart of tpu_ofdm/apps/run_flowgraph.py).

Usage:
  python -m tpu_ofdm_torch.apps.run_flowgraph graph.json --tone 0.1 --steps 20
  python -m tpu_ofdm_torch.apps.run_flowgraph graph.json --file cap.c64 \
      --block-size 65536 --print-output
  python -m tpu_ofdm_torch.apps.run_flowgraph examples/psd_probe.json \
      --tone 0.125 --device cpu

Feeds the compiled graph from a file or synthetic source, reports
throughput (the probe_rate / perf-counter story), and optionally prints or
saves the last output pytree.
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from tpu_ofdm_torch import grc
from tpu_ofdm_torch.apps.common import (add_device_arg, add_source_args,
                                        make_source, to_host)
from tpu_ofdm_torch.stream.executor import (StreamExecutor, tree_leaves,
                                            tree_map)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("spec", help="JSON flowgraph spec file")
    add_source_args(p)
    add_device_arg(p)
    p.add_argument("--block-size", type=int, default=1 << 15)
    p.add_argument("--steps", type=int, default=10,
                   help="time-blocks to run (synthetic sources run forever)")
    p.add_argument("--print-output", action="store_true",
                   help="print the final step's output pytree")
    p.add_argument("--save-output", help="save final output to .npz")
    args = p.parse_args(argv)

    with open(args.spec) as f:
        spec = json.load(f)
    block = grc.build(spec)
    print(f"flowgraph {block.name!r} compiled "
          f"({len(spec.get('blocks', []))} blocks)")

    ex = StreamExecutor(block, args.block_size, device=args.device)
    src = make_source(args, args.block_size)
    # a multi-input graph (e.g. examples/channelizer_waterfall.json) gets
    # the SAME source stream on every declared input, matching the GRC idiom
    # of fanning one source out to parallel chains
    n_in = len(spec.get("inputs", [])) or 1
    last = None
    steps = 0
    for x in src:
        last = ex.push(x if n_in == 1 else (x,) * n_in)
        steps += 1
        if steps >= args.steps:
            break
    if last is None:
        print("source produced no samples", file=sys.stderr)
        return 1
    if ex.device.type == "cuda":
        torch.cuda.synchronize(ex.device)
    out = to_host(last)
    print(f"{steps} steps, {ex.samples_in} samples, "
          f"{ex.samples_per_sec / 1e6:.1f} Msamples/s")
    if args.print_output:
        print(tree_map(
            lambda a: (tuple(a.shape), str(a.numpy().dtype)), out))
        print(out)
    if args.save_output:
        np.savez(args.save_output, **{
            f"out_{i}": a.numpy() for i, a in enumerate(tree_leaves(out))})
        print(f"saved {args.save_output}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
