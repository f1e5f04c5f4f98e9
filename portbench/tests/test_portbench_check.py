"""The check that decides `correct`, driven through a whole run on the CPU
at a small size: a sound run passes; the control (the reference in
bfloat16 in the program's place) fails; and so does a run whose timed path
is broken underneath, for each fault a cell can have."""

import pytest
import torch

from portbench import cells, check, control, harness
from tpu_ofdm_torch.stream.block import Block

CELLS = ["rx64_dense", "wideband64_3ch", "rx64_file_i16c", "radio64_duplex"]
SEED = 2**31 + 4242


def run(cell):
    return harness.run_cell(cell, SEED, 0.6, False, device="cpu")


@pytest.mark.parametrize("name", CELLS)
def test_a_sound_run_is_correct(small_cell, name):
    r = run(small_cell(name))
    assert r["correct"], r["checks"]
    assert r["failed"] == 0 and r["attempted"] > 0
    assert list(r)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
def test_the_control_is_not_correct(small_cell, name):
    cell = small_cell(name)
    got = control.readings(cell, SEED, 0.3, "cpu")
    assert check.verdict(got["program"], cell.limits)
    numbers = {"pushes_wrong": 0, **got["control"]}
    assert not check.verdict(numbers, cell.limits), numbers


def rx_of(out):
    """The receiver's half of a path's output."""
    return out.rx if hasattr(out, "rx") else out


def state_unchanged(apply):
    def f(state, x):
        return state, apply(state, x)[1]
    return f


def half_left_out(apply):
    def f(state, x):
        state, out = apply(state, x)
        res = rx_of(out).result
        res.valid[0::2] = False
        return state, out
    return f


def answer_altered(apply):
    def f(state, x):
        state, out = apply(state, x)
        rx_of(out).result.frames.payload[..., 0] ^= 1
        return state, out
    return f


def tx_altered(apply):
    def f(state, x):
        state, out = apply(state, x)
        out.tx.samples[100] += 0.01
        return state, out
    return f


def reported_twice(apply):
    """A frame reported a second time, at its own start on its own
    channel, with a failed CRC32: an empty slot beside it copies it."""
    def f(state, x):
        state, out = apply(state, x)
        res = rx_of(out).result
        K = res.valid.shape[-1]
        valid = res.valid.reshape(-1, K)
        for r in range(valid.shape[0]):
            on, off = valid[r].nonzero().flatten(), (~valid[r]).nonzero()
            if len(on) and len(off):
                i, j = r * K + int(on[0]), r * K + int(off[0])
                for t in (*res.frames, res.starts, res.fine_cfo):
                    if t.numel():
                        rows = t.view(valid.numel(), -1)
                        rows[j] = rows[i]
                res.frames.crc_ok.view(-1)[j] = False
                valid.view(-1)[j] = True
                break
        return state, out
    return f


FAULTS = {"state_unchanged": state_unchanged, "half_left_out": half_left_out,
          "answer_altered": answer_altered, "reported_twice": reported_twice}


@pytest.mark.parametrize("fault", sorted(FAULTS) + ["tx_altered"])
@pytest.mark.parametrize("name", CELLS)
def test_a_broken_timed_path_is_not_correct(small_cell, monkeypatch, name,
                                            fault):
    cell = small_cell(name)
    if fault == "tx_altered" and name != "radio64_duplex":
        pytest.skip("only the radio has a TX half")
    wrap = FAULTS.get(fault, tx_altered)
    cls = cells.path_class(cell.traffic["path"])
    setup = cls.setup

    def broken_setup(self):
        setup(self)
        b = self.ex.block
        self.ex.block = Block(b.init, wrap(b.apply), b.name, b.latency,
                              b.stream_input)

    monkeypatch.setattr(cls, "setup", broken_setup)
    with torch.no_grad():
        r = run(cell)
    assert not r["correct"], r["checks"]


# a seed whose wideband capture, at the tests' size, has a frame on channel
# 40 whose leak into channel 41 passes its header CRC8 (and fails its CRC32)
GHOST_SEED = 3600314169


def test_a_ghost_in_the_next_channel_is_judged_by_the_reference(small_cell):
    cell = small_cell("wideband64_3ch")
    path, loop = harness.setup(cell, GHOST_SEED, "cpu")
    keep = harness.Reservoir(4, GHOST_SEED)
    loop.run(pushes=4, keep=keep)
    numbers = check.judge(path, keep.kept, loop.tallies)
    assert numbers["ghost_frames"] >= 1
    assert check.verdict(numbers, cell.limits), numbers
    ghosts = [(step, g) for step, out, frames in keep.kept
              for g in path.for_check(out, frames)
              if g["channel"] not in cell.traffic["channels"]]
    assert ghosts and all(not g["crc_ok"] for _, g in ghosts)
    step, g = ghosts[0]
    sent = [(c, pos) for c, pos, _ in path.expected(step)]
    assert check.is_ghost(path, step, g, sent)
    for altered in ({"crc_ok": True}, {"abs_start": g["abs_start"] + 7},
                    {"abs_start": g["abs_start"] + 3000}):
        assert not check.is_ghost(path, step, {**g, **altered}, sent), altered
    # the same report where a frame was sent on its channel is a second
    # report of that frame, never a ghost
    near = sent + [(g["channel"], g["abs_start"] - 20)]
    assert not check.is_ghost(path, step, g, near)
    path.n_chan = 1
    assert not check.is_ghost(path, step, g, sent)
