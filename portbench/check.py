"""What decides `correct`: the program's frames against the reference's.

Every push of the window (and of the traced stretch) must return as many
frames with a good CRC as were sent (`pushes_wrong`).  The pushes that a
seeded reservoir kept are judged frame by frame:

  frames_wrong  frames sent but not reported, or reported twice, or with
                another payload, frame number, crc_ok or hdr_ok than the
                reference decodes; frames reported where none was sent,
                unless they are ghosts; and, for the radio, TX slots
                accepted or refused wrongly
  ghost_frames  (not compared) in a cell of several channels, frames
                reported on a channel where no frame was sent within the
                reference's search span, with a failed CRC32, at a start
                where the reference's metric on that channel peaks above
                the detection threshold.  In the wideband cell a frame
                leaks into the next channel through the channelizer's
                transition band; its preamble is detected there, and now
                and then the garbled header passes its CRC8 (whether it
                does turns on rounding: the reference's may not).  A second
                report of a frame that was sent is never a ghost.
  detect_gap    how far below the reference's best the smoothed metric
                lies at the start the program picked, as a share of the
                best (0 where both pick the same sample)
  cfo_gap       |fine CFO - the reference's at the program's start|, in
                subcarriers
  evm_gap       |EVM - the reference's EVM at the program's start| as a
                share of the reference's
  tx_gap        (radio) the widest gap between the TX half's output block
                and the reference's

The reference follows the program's start (it demodulates where the
program found the frame); that start is judged by itself, by detect_gap.
The control puts the reference, computed in bfloat16, in the program's
place and is judged by the same code.
"""

from __future__ import annotations

import numpy as np

from portbench.reference import receiver as R

# a ghost's start lies where the reference's metric is within this share of
# its best: the narrowband cells' detect_gap limit
GHOST_PLATEAU = 1e-4
# OfdmConfig's default sync_threshold, which the configurations keep
SYNC_THRESHOLD = 0.6

ORDER = ("pushes_wrong", "frames_wrong", "ghost_frames", "detect_gap",
         "cfo_gap", "evm_gap", "tx_gap")


def judge_push(path, step: int, frames: list[dict]) -> dict:
    """The numbers of one kept push, whose reported frames are `frames`
    (dicts as collect_frames gives them, with "channel" where there are
    several)."""
    s = path.ref
    out = {"frames_wrong": 0, "ghost_frames": 0, "detect_gap": 0.0,
           "cfo_gap": 0.0, "evm_gap": 0.0}
    left = list(frames)
    for ch, pos, f in path.expected(step):
        near = [g for g in left if g.get("channel", 0) == ch
                and pos - path.span <= g["abs_start"] <= pos + path.span
                + s.cp_len]
        if not near:
            out["frames_wrong"] += 1
            continue
        g = near[0]
        left.remove(g)

        def stream(lo, hi, ch=ch):
            return path.stream(ch, lo, hi)

        det = R.detect(s, stream, pos, path.span, path.t_origin(step))
        j = R.argmax_of(s, g["abs_start"])
        out["detect_gap"] = max(out["detect_gap"], det.gap(j))
        inside = det.gap(j) < 1.0
        cfo = det.fine_cfo(j) if inside else 0.0
        if "fine_cfo" in g:
            out["cfo_gap"] = max(out["cfo_gap"], abs(g["fine_cfo"] - cfo))
        ref = R.demod(s, stream(g["abs_start"],
                                g["abs_start"] + s.max_frame_len), cfo)
        ok = (inside and ref["hdr_ok"] and ref["payload"] == f.payload
              and ref["frame_num"] == f.frame_num and ref["crc_ok"]
              and g["payload"] == f.payload
              and g["frame_num"] == f.frame_num and g["crc_ok"]
              and g.get("hdr_ok", True))
        out["frames_wrong"] += not ok
        if ref["hdr_ok"]:
            out["evm_gap"] = max(out["evm_gap"],
                                 abs(g["evm"] - ref["evm"]) / ref["evm"])
    sent = [(ch, pos) for ch, pos, _ in path.expected(step)]
    for g in left:
        ghost = is_ghost(path, step, g, sent)
        out["ghost_frames"] += ghost
        out["frames_wrong"] += not ghost
    return out


def is_ghost(path, step: int, g: dict, sent) -> bool:
    """Whether a frame that no frame sent accounts for is a ghost: in a
    cell of several channels, on a channel where no frame of `sent`
    ((channel, absolute position) of push `step`'s frames) lies within the
    search span, delivering nothing (its CRC32 failed), where the
    reference detects a preamble too: at the best of the reference's
    metric on that channel, above the detection threshold."""
    ch = g.get("channel", 0)
    if (g["crc_ok"] or getattr(path, "n_chan", 1) < 2
            or any(c == ch and abs(g["abs_start"] - pos) <= path.span
                   + path.ref.cp_len for c, pos in sent)):
        return False
    s = path.ref

    def stream(lo, hi):
        return path.stream(ch, lo, hi)

    j = R.argmax_of(s, g["abs_start"])
    det = R.detect(s, stream, j, path.span, path.t_origin(step))
    return det.gap(j) <= GHOST_PLATEAU and det.metric(j) > SYNC_THRESHOLD


def control_frames(path, step: int, q=R.bf16) -> list[dict]:
    """What the reference computed with rounding q reports for push
    `step`: its own detection near each frame sent, then its demod."""
    s = path.ref
    frames = []
    for ch, pos, _ in path.expected(step):
        def stream(lo, hi, ch=ch):
            return path.stream(ch, lo, hi, q)

        det = R.detect(s, stream, pos, path.span, path.t_origin(step), q)
        j = det.best()
        start = R.start_of(s, j)
        cfo = det.fine_cfo(j)
        d = R.demod(s, stream(start, start + s.max_frame_len), cfo, q)
        if d["hdr_ok"]:
            frames.append({"channel": ch, "abs_start": start,
                           "fine_cfo": cfo, **d})
    return frames


def merge(parts: list[dict]) -> dict:
    """Gaps take the widest, counts add."""
    out: dict = {}
    for p in parts:
        for k, v in p.items():
            out[k] = max(out.get(k, 0.0), v) if k.endswith("_gap") \
                else out.get(k, 0) + v
    return out


def pushes_wrong(path, tallies) -> int:
    """Pushes whose count of frames with a good CRC differs from the
    frames sent; tallies are (step, frames, CRC failures).  A frame that
    fails its CRC is judged in the kept pushes."""
    return sum(n - bad != len(path.expected(step))
               for step, n, bad in tallies)


def judge(path, kept, tallies) -> dict:
    """The numbers of a run: kept is [(step, out, frames)], the frames as
    the window's sink returned them."""
    parts = [{"pushes_wrong": pushes_wrong(path, tallies)}]
    for step, out, frames in kept:
        parts.append(judge_push(path, step, path.for_check(out, frames)))
        if hasattr(path, "tx_block"):
            parts.append({"tx_gap": path.tx_gap(out, step),
                          "frames_wrong": path.tx_wrong(out)})
    return {k: v for k, v in sorted(merge(parts).items(),
                                    key=lambda kv: ORDER.index(kv[0]))}


def control(path, steps, q=R.bf16) -> dict:
    """The control's numbers on the pushes `steps`."""
    parts = []
    for step in steps:
        parts.append(judge_push(path, step, control_frames(path, step, q)))
        if hasattr(path, "tx_block"):
            want = path.tx_block(step)
            parts.append({"tx_gap": float(np.abs(q(want) - want).max())})
    return {k: v for k, v in sorted(merge(parts).items(),
                                    key=lambda kv: ORDER.index(kv[0]))}


def verdict(numbers: dict, limits: dict) -> bool:
    """Every number that the cell's limits name at or under its limit; a
    limit without a number fails.  A number without a limit is reported
    and not compared (limits/<cell>.json says why)."""
    return all(k in numbers and numbers[k] <= v for k, v in limits.items())
