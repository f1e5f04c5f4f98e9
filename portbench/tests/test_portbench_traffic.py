"""The traffic generator: deterministic for a seed, different across
seeds, the same work for every seed; frames that the reference decodes."""

import numpy as np
import pytest
import torch

from portbench import cells, tracing
from portbench import traffic as T
from portbench.reference import receiver as R

SEED = 2**31 + 977


def blocks_of(cell, seed):
    path = cells.path_class(cell.traffic["path"])(
        cell.config, cell.traffic, seed, "cpu", tracing.Spans())
    return path, path.make_blocks()


@pytest.mark.parametrize("name", ["rx64_dense", "wideband64_3ch"])
def test_traffic_is_deterministic_for_a_seed(small_cell, name):
    cell = small_cell(name)
    _, a = blocks_of(cell, SEED)
    _, b = blocks_of(cell, SEED)
    _, c = blocks_of(cell, SEED + 1)
    assert torch.equal(a, b)
    assert not torch.equal(a, c)


def test_payload_lengths_are_one_multiset_across_seeds():
    lens = []
    for seed in (1, SEED):
        pays, nums = T.payloads(np.random.default_rng(seed), 448, 1, 252)
        lens.append(sorted(len(p) for p in pays))
        assert all(0 <= n < 4096 for n in nums)
    assert lens[0] == lens[1]
    assert lens[0][0] == 1 and lens[0][-1] == 252


def test_a_frame_round_trips_through_the_reference():
    s = R.Spec(fft_len=64, cp_len=16, modulation="qpsk",
               max_payload_bytes=256)
    rng = np.random.default_rng(5)
    pay = rng.integers(0, 256, 200, dtype=np.uint8).tobytes()
    f = T.golden(s, pay, 1234)
    x = np.zeros(6000, np.complex128)
    x[1000:1000 + len(f)] = f
    x += 0.02 * (rng.standard_normal(6000) + 1j * rng.standard_normal(6000))

    def stream(lo, hi):
        return x[lo:hi]

    det = R.detect(s, stream, 1000, 48, 0)
    j = det.best()
    start = R.start_of(s, j)
    assert 1000 <= start <= 1000 + s.cp_len
    d = R.demod(s, stream(start, start + s.max_frame_len), det.fine_cfo(j))
    assert d["hdr_ok"] and d["crc_ok"]
    assert d["payload"] == pay and d["frame_num"] == 1234
    assert d["evm"] < 0.1


def test_bf16_rounds_to_eight_bits_of_mantissa():
    x = np.array([1.0, 1.0 + 2**-8, 1.0 + 2**-7, 3.14159])
    assert list(R.bf16(x)) == [1.0, 1.0, 1.0 + 2**-7, 3.140625]
    z = R.bf16(np.array([1.0 + 2**-7 + 1j * 3.14159]))
    assert z[0] == 1.0 + 2**-7 + 3.140625j
