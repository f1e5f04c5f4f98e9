"""Readings that the check's limits are set from, at a cell's own size.

    python3 portbench/control.py --workload <name> --seeds 1 2 3 ... \
        [--seconds 2] [--out control_<name>.json]

For each seed: the cell's set-up and a short window of the program at the
cell's own load, judged as a run judges it (the lower readings), then the
control on the same kept pushes (the upper readings): the reference
computed in bfloat16, the precision below the configuration's float32,
in the program's place.  One process for all seeds, on the card.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent))

from portbench import cells, check, harness  # noqa: E402


def readings(cell, seed: int, seconds: float, device="cuda") -> dict:
    path, loop = harness.setup(cell, seed, device)
    try:
        keep = harness.Reservoir(cell.traffic["kept_pushes"], seed)
        loop.run(until=time.perf_counter() + seconds, keep=keep)
        program = check.judge(path, keep.kept, loop.tallies)
        steps = [step for step, _, _ in keep.kept]
        del keep
        t = time.perf_counter()
        ctl = check.control(path, steps)
        return {"seed": seed, "program": program, "control": ctl,
                "control_s": time.perf_counter() - t}
    finally:
        path.close()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    cell = cells.cell(args.workload)
    rows = []
    for seed in args.seeds:
        rows.append(readings(cell, seed, args.seconds))
        print(json.dumps(rows[-1]), flush=True)
    summary = {}
    for side in ("program", "control"):
        for k in rows[0][side]:
            vals = [r[side][k] for r in rows]
            summary[f"{side}.{k}"] = [min(vals), max(vals)]
    print(json.dumps({"workload": args.workload, "summary": summary}))
    if args.out:
        out = pathlib.Path(args.out)
        out.parent.mkdir(parents=True, exist_ok=True)
        out.write_text(json.dumps({"rows": rows, "summary": summary},
                                  indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
