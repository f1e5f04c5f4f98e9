"""rx_block's CUDA-graph step (modem/rx.py StepGraphs) on the CPU.

On the CPU rx_block runs eagerly, captures nothing and counts no replay.
The card's capture and replay are reached through a CPU stand-in for
CudaGraphCalls, whose "graph" reruns the captured function and copies its
outputs into the tensors the capture returned, as a replay writes its
static buffers: the step then takes the card's path (warm-up, capture,
replays, the flat output buffer and its copy), and its results must equal
the eager step's bit for bit, own their memory, and stay as they were
while later steps replay."""

import contextlib
import functools
import gc

import numpy as np
import pytest
import torch

import tests.golden.golden_ofdm as G
from tpu_ofdm_torch import config as tconfig
from tpu_ofdm_torch.config import StreamConfig
from tpu_ofdm_torch.kernels.gather import gather_windows
from tpu_ofdm_torch.modem import rx as trx
from tpu_ofdm_torch.modem.rx_stream import (RxStreamOut, collect_frames,
                                            history_len, rx_stream_block)
from tpu_ofdm_torch.modem.wideband import (WidebandRxOut,
                                           collect_wideband_frames)
from tpu_ofdm_torch.ops.sync import derotate, detect_frames
from tpu_ofdm_torch.stream.executor import StreamExecutor
from tpu_ofdm_torch.utils import metrics

SPEC = tconfig.OfdmConfig(fft_len=64, cp_len=16, modulation="qpsk").spec
S = 1 << 13
K = 6
H = history_len(SPEC)
PUSHES = 6
# frame starts in every block, two across a seam
POSITIONS = [300, S - 500, S + 2500, 2 * S - 1, 3 * S + 4000, 4 * S - 900,
             5 * S + 100]


@functools.lru_cache(maxsize=None)
def _stream(seed: int = 5) -> np.ndarray:
    rng = np.random.RandomState(seed)
    gp = G.GoldenOfdmParams(fft_len=64, cp_len=16, modulation="qpsk")
    n = PUSHES * S
    x = np.zeros(n, np.complex128)
    for i, p in enumerate(POSITIONS):
        msg = rng.randint(0, 256, 10 + 17 * i).astype(np.uint8).tobytes()
        f = G.tx_frame(gp, msg, frame_num=i)
        x[p:p + len(f)] += f[: n - p]
    x *= np.exp(2j * np.pi * 0.21 * np.arange(n) / 64)
    x += 0.04 * (rng.randn(n) + 1j * rng.randn(n))
    return x.astype(np.complex64)


def _blocks(batched: bool) -> list[tuple[torch.Tensor, torch.Tensor]]:
    """(block, history) of each push, as the streaming receiver passes
    them: two channels (the second the stream from another seed) when
    batched."""
    x = torch.as_tensor(_stream())
    if batched:
        x = torch.stack([x, torch.as_tensor(_stream(6))])
    padded = torch.cat([torch.zeros((*x.shape[:-1], H), dtype=x.dtype), x],
                       dim=-1)
    return [(x[..., i * S:(i + 1) * S].contiguous(),
             padded[..., i * S:i * S + H].contiguous())
            for i in range(PUSHES)]


class _StubGraph:
    def __init__(self, fn, out):
        self.fn, self.out = fn, out

    def replay(self):
        for static, fresh in zip(_tensors(self.out), _tensors(self.fn())):
            static.copy_(fresh)

    def pool(self):
        return None


def _tensors(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, tuple):
        return [t for sub in tree for t in _tensors(sub)]
    return []


class _Done:
    """The stand-in's readback: its host buffers are filled only when the
    sink waits on it, so a sink that read them before waiting would read
    zeros."""

    def __init__(self, pairs):
        self.pairs = pairs

    def synchronize(self):
        for host, t in self.pairs:
            host.copy_(t)


class CpuGraphCalls:
    """CudaGraphCalls on the CPU: one side stream (the current one), a
    stream id the test sets, stub graphs, and the step events and
    readbacks as objects: `marks` holds each event made, `reads` each
    (event, record, index) read back."""

    def __init__(self):
        self.stream_id = 0
        self.marks, self.reads = [], []

    def usable(self, x):
        return True

    def stream(self, dev):
        return self.stream_id

    def side(self, dev):
        return contextlib.nullcontext()

    def capture(self, fn, pool=None):
        out = fn()
        return _StubGraph(fn, out), out

    def keep(self, tensors, dev):
        pass

    def mark(self, dev):
        self.marks.append(object())
        return self.marks[-1]

    def read(self, event, record, index):
        assert event in self.marks
        self.reads.append((event, record, index))
        rec, host = trx.host_buffer(record, index)
        rec.zero_()
        pairs = [(rec, record)] + ([] if index is None else [(host, index)])
        return rec, host, _Done(pairs)


@pytest.fixture
def graphs(monkeypatch):
    """A fresh StepGraphs on the CPU stand-in, as rx_block's."""
    g = trx.StepGraphs(calls=CpuGraphCalls())
    monkeypatch.setattr(trx, "STEP_GRAPHS", g)
    return g


@pytest.fixture
def counted():
    was = metrics.enable(True)
    metrics.drain()
    try:
        yield
    finally:
        metrics.enable(was)
        metrics.drain()


def _graph_counts() -> dict:
    return {k: v for k, v in metrics.drain().counters.items()
            if k.startswith("rx.graph")}


def _same_bits(a: trx.RxBlockResult, b: trx.RxBlockResult) -> bool:
    return all(x.dtype == y.dtype and x.shape == y.shape
               and torch.equal(trx._bytes(x), trx._bytes(y))
               for x, y in zip(trx._leaves(a), trx._leaves(b)))


def _rx_block_before_graphs(x, max_frames, own_lo, own_hi, head, equalizer,
                            output):
    """rx_block as it was written before its step was split for the
    graphs: detect_frames, the ownership mask, gather, derotate, demod."""
    nv = x.shape[-1] + (0 if head is None else head.shape[-1])
    det = detect_frames(SPEC, x, max_frames, head=head)
    owned = det.valid & (det.start >= own_lo) & (det.start < own_hi)
    F = SPEC.max_frame_len
    gstart = det.start.clamp(0, max(nv - F, 0))
    wins = derotate(gather_windows(x, gstart, F, head=head), det.fine_cfo,
                    SPEC.fft_len)
    lead = wins.shape[:-1]
    flat = trx.demod_frame(SPEC, wins.reshape(-1, F), equalizer, output)
    frames = trx.FrameResult(*(f.reshape(*lead, *f.shape[1:])
                               for f in flat))
    valid = owned & frames.sync_ok & frames.hdr_ok
    return trx.RxBlockResult(frames, det.start, det.fine_cfo, valid)


STEPS = [(False, "pilot_phase", "hard"), (False, "simpledfe", "soft"),
         (True, "pilot_phase", "hard")]


@pytest.mark.parametrize("batched,equalizer,output", STEPS)
def test_cpu_step_is_eager_and_unchanged(batched, equalizer, output,
                                         counted):
    """On the CPU: nothing captured or cached, no graph counter, and every
    field as the step before the graphs gave it."""
    for x, head in _blocks(batched)[:2]:
        got = trx.rx_block(SPEC, x, K, own_lo=0, own_hi=S, head=head,
                           equalizer=equalizer, output=output)
        want = _rx_block_before_graphs(x, K, 0, S, head, equalizer, output)
        assert _same_bits(got, want)
    assert got.valid.any()
    assert not trx.STEP_GRAPHS.steps
    assert _graph_counts() == {}


@pytest.mark.parametrize("batched,equalizer,output", STEPS)
def test_replayed_step_equals_eager_and_owns_its_memory(
        batched, equalizer, output, graphs, counted):
    """Push after push through the stand-in's capture and replays: each
    result bit-identical to the eager step; none of its tensors shares
    memory with the step's static buffers; and each unchanged after the
    next three pushes replay over those buffers."""
    opts = dict(own_lo=0, own_hi=S, equalizer=equalizer, output=output)
    results, copies = [], []
    for x, head in _blocks(batched):
        got = trx.rx_block(SPEC, x, K, head=head, **opts)
        want = trx.rx_block_eager(SPEC, x, K, head=head, **opts)
        assert _same_bits(got, want)
        results.append(got)
        copies.append(trx._from_leaves([t.clone()
                                        for t in trx._leaves(got)]))
    assert sum(int(r.valid.sum()) for r in results) >= len(POSITIONS) - 1
    assert _graph_counts() == {"rx.graph_eager": 2,
                               "rx.graph_replay": PUSHES - 2}
    (step,) = graphs.steps.values()
    static = [step.rows, step.wins, step.flat, *_tensors(step.sel)]
    static_ptrs = {t.untyped_storage().data_ptr() for t in static}
    for r, c in zip(results, copies):
        for t in trx._leaves(r):
            assert t.untyped_storage().data_ptr() not in static_ptrs
        assert _same_bits(r, c)


SINK_FIELDS = ("valid", "payload", "payload_len", "frame_num", "hdr_ok",
               "crc_ok", "evm", "int_cfo", "starts", "fine_cfo")


@pytest.mark.parametrize("payload,shape,max_frames,span", [
    (256, (1 << 16,), 480, 135_840),       # fft 64, K 480
    (64, (64, 1 << 12), 4, 23_296)])       # wideband: 64 channels, K 4
def test_layout_puts_the_sinks_fields_first(payload, shape, max_frames,
                                            span):
    """The flat buffer opens with the ten fields the sink reads, one after
    another in one span of `span` bytes; the LLRs follow, then the
    symbols and the rest, which the sink never reads."""
    spec = tconfig.OfdmConfig(fft_len=64, cp_len=16, modulation="qpsk",
                              max_payload_bytes=payload).spec
    x = torch.zeros(shape, dtype=torch.complex64)
    res = trx.rx_block_eager(spec, x, max_frames, 0, shape[-1], None,
                             "pilot_phase", "hard")
    layout = trx._Layout(trx._leaves(res))
    at = dict(zip(trx._NAMES, layout.fields))
    end = 0
    for name in SINK_FIELDS:
        off, n, *_ = at[name]
        assert end <= off < end + layout.ALIGN, name
        end = off + n
    assert end == span
    assert at["llr"][0] == span
    for name in ("data_syms", "sym_mask", "sync_q", "sync_ok"):
        assert at[name][0] >= span


# sink: (batched, output, collect(outs)) -- the narrowband sink, hard and
# soft, and the wideband sink on a batched step
SINKS = {
    "hard": (False, "hard", lambda outs: collect_frames(outs, S, H)),
    "soft": (False, "soft", lambda outs: collect_frames(outs, S, H)),
    "wideband": (True, "hard",
                 lambda outs: collect_wideband_frames(outs, S, SPEC)),
}


def _outs(sink, results, first=0):
    """The receiver's step outputs around `results`, with step indices from
    `first` on."""
    out = WidebandRxOut if SINKS[sink][0] else RxStreamOut
    return [out(r, torch.tensor(first + i, dtype=torch.int32))
            for i, r in enumerate(results)]


def _same_dicts(frames, expected):
    assert [list(f) for f in frames] == [list(f) for f in expected]
    for f, e in zip(frames, expected):
        for key in e:
            assert type(f[key]) is type(e[key])
            if key == "llr":
                np.testing.assert_array_equal(f[key], e[key])
            else:
                assert f[key] == e[key]


@contextlib.contextmanager
def _host_reads(monkeypatch):
    """The host reads of tensors made inside the block (.cpu(), int(),
    .item(), .numpy(), .tolist()), as (method, tensor) pairs."""
    reads = []
    with monkeypatch.context() as m:
        for name in ("cpu", "__int__", "item", "numpy", "tolist"):
            method = getattr(torch.Tensor, name)

            def counted(t, *args, _name=name, _method=method, **kwargs):
                reads.append((_name, t))
                return _method(t, *args, **kwargs)
            m.setattr(torch.Tensor, name, counted)
        yield reads


@pytest.mark.parametrize("output", list(SINKS))
def test_replayed_step_gives_the_eager_dicts_in_one_readback(
        output, graphs, monkeypatch):
    """The sink on a replayed step reads its record and index back in one
    readback on the readback stream (the stand-in's `read`), after the
    step's own event, with no .cpu() and no host read of the index, and
    gives the eager step's dicts."""
    batched, out, run = SINKS[output]
    opts = dict(own_lo=0, own_hi=S, equalizer="pilot_phase", output=out)
    n = 0
    for i, (x, head) in enumerate(_blocks(batched)):
        got = trx.rx_block(SPEC, x, K, head=head, **opts)
        want = trx.rx_block_eager(SPEC, x, K, head=head, **opts)
        expected = run(_outs(output, [want], i))
        outs = _outs(output, [got], i)
        graphs.calls.reads.clear()
        with _host_reads(monkeypatch) as reads:
            frames = run(outs)
        if i >= 2:                            # the replays
            (read,) = graphs.calls.reads
            assert read[0] is graphs.calls.marks[-1]
            assert read[2] is outs[0][1]
            assert [name for name, _ in reads if name == "cpu"] == []
            assert not any(t is outs[0][1] for _, t in reads)
        else:
            assert graphs.calls.reads == []
        _same_dicts(frames, expected)
        n += len(frames) if i >= 2 else 0
    assert n >= 3


@pytest.mark.parametrize("sink", ["hard", "wideband"])
def test_three_replayed_steps_collected_at_once_give_each_steps_dicts(
        sink, monkeypatch, counted):
    """Three replayed steps pushed before one collect give the dicts that
    collecting each step right after its push gives, in step order, each
    read back after its own event (counter "sink.side")."""
    batched, out, run = SINKS[sink]
    opts = dict(max_frames=K, own_lo=0, own_hi=S, equalizer="pilot_phase",
                output=out)
    blocks = _blocks(batched)
    at_once = []
    for g in range(2):
        monkeypatch.setattr(trx, "STEP_GRAPHS",
                            trx.StepGraphs(calls=CpuGraphCalls()))
        results = [trx.rx_block(SPEC, x, head=head, **opts)
                   for x, head in blocks[:2]]
        if g == 0:
            for i, (x, head) in enumerate(blocks[2:5]):
                at_once += run(_outs(sink, [trx.rx_block(SPEC, x, head=head,
                                                         **opts)], 2 + i))
        else:
            results = [trx.rx_block(SPEC, x, head=head, **opts)
                       for x, head in blocks[2:5]]
            metrics.drain()
            frames = run(_outs(sink, results, 2))
            counters = metrics.drain().counters
            assert len(trx.STEP_GRAPHS.calls.reads) == 3
    assert len(at_once) >= 3
    _same_dicts(frames, at_once)
    assert counters["sink.side"] == counters["sink.packed"] == 3
    assert "sink.fields" not in counters


def test_sink_side_counts_each_replayed_step_once(graphs, counted):
    """Counter "sink.side": one per replayed step collected, none for the
    key's first two (eager) steps, which are read field by field; and a
    step's event goes with its record."""
    ex = StreamExecutor(rx_stream_block(SPEC, StreamConfig(S, K)), S,
                        device="cpu")
    x = torch.as_tensor(_stream())
    frames = []
    for i in range(PUSHES):
        frames += collect_frames([ex.push(x[i * S:(i + 1) * S])], S, H)
    got = metrics.drain().counters
    assert got["sink.side"] == got["sink.packed"] == PUSHES - 2
    assert got["sink.fields"] == 2
    assert got["rx.graph_replay"] == PUSHES - 2
    assert len(graphs.calls.marks) == len(graphs.calls.reads) == PUSHES - 2
    assert len(frames) == len(POSITIONS)

    def mine():
        return [m for m in trx._MARKS.values() if m[0] is graphs.calls]
    assert len(mine()) == PUSHES - 2           # the stand-in holds each
    graphs.calls.reads.clear()                 # record it read
    gc.collect()
    assert mine() == []


def test_an_eager_step_records_no_event(counted):
    """On the CPU without the stand-in, no step records an event and every
    step is read field by field."""
    x, head = _blocks(False)[2]
    res = trx.rx_block(SPEC, x, K, own_lo=0, own_hi=S, head=head)
    assert trx.step_mark(res.valid) is None
    collect_frames([RxStreamOut(res, torch.tensor(2, dtype=torch.int32))],
                   S, H)
    got = metrics.drain().counters
    assert got["sink.fields"] == 1 and "sink.side" not in got


def _call(x, head, **kw):
    opts = dict(max_frames=K, own_lo=0, own_hi=S, head=head,
                equalizer="pilot_phase", output="hard")
    opts.update(kw)
    return trx.rx_block(SPEC, x, **opts)


VARIANTS = {
    "x_len": lambda x, head: (x[: S // 2].contiguous(), head, {}),
    "head_len": lambda x, head: (x, head[: H // 2].contiguous(), {}),
    "no_head": lambda x, head: (x, None, {}),
    "max_frames": lambda x, head: (x, head, {"max_frames": K + 1}),
    "own_lo": lambda x, head: (x, head, {"own_lo": 1}),
    "own_hi": lambda x, head: (x, head, {"own_hi": S - 1}),
    "equalizer": lambda x, head: (x, head, {"equalizer": "simpledfe"}),
    "output": lambda x, head: (x, head, {"output": "soft"}),
    "spec": lambda x, head: (x, head, {"spec": tconfig.OfdmConfig(
        fft_len=64, cp_len=16, modulation="bpsk").spec}),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS) + ["stream"])
def test_cache_key_separates(variant, graphs, counted):
    """A step differing from a captured one in a shape, an option, the
    ownership window or the stream gets steps of its own: its first call
    runs eagerly, its second captures new buffers, and the captured step
    replays on as before."""
    x, head = _blocks(False)[1]
    _call(x, head)
    _call(x, head)                            # captured
    base = graphs.steps[next(iter(graphs.steps))]
    if variant == "stream":
        graphs.calls.stream_id = 1
        vx, vhead, kw = x, head, {}
    else:
        vx, vhead, kw = VARIANTS[variant](x, head)
    spec = kw.pop("spec", SPEC)
    for _ in range(2):
        trx.rx_block(spec, vx, **{**dict(max_frames=K, own_lo=0, own_hi=S,
                                         head=vhead), **kw})
    assert _graph_counts() == {"rx.graph_eager": 4}
    assert len(graphs.steps) == 2
    other = graphs.steps[next(reversed(graphs.steps))]
    assert other is not base
    assert other.flat.data_ptr() != base.flat.data_ptr()
    graphs.calls.stream_id = 0
    _call(x, head)
    assert _graph_counts() == {"rx.graph_replay": 1}


def test_least_recently_used_step_goes(graphs, counted):
    """Past `size` keys, the step used longest ago is dropped and starts
    over from an eager call."""
    graphs.size = 2
    x, head = _blocks(False)[1]
    lens = (S, S // 2, S // 4)
    for n in lens:
        _call(x[:n].contiguous(), head)
        _call(x[:n].contiguous(), head)
    assert [k[3] for k in graphs.steps] == [(S // 2,), (S // 4,)]
    _call(x, head)
    _call(x[: S // 4].contiguous(), head)
    assert _graph_counts() == {"rx.graph_eager": 7, "rx.graph_replay": 1}


@pytest.mark.parametrize("batched", [False, True])
def test_kernel_wrappers_write_into_out(batched):
    """sc_detect_rows and gather_windows with `out`: the same values as
    without, in the given buffer; a buffer of another shape is refused."""
    from tpu_ofdm_torch.kernels.sc_detect import ROW, sc_detect_rows

    x, head = _blocks(batched)[1]
    B = x.shape[0] if batched else 1
    rows = torch.empty((6, B, -(-(x.shape[-1] + H) // ROW)))
    got = sc_detect_rows(x, 32, 16, head=head, out=rows)
    want = sc_detect_rows(x, 32, 16, head=head)
    for a, b in zip(got, want):
        assert torch.equal(trx._bytes(a), trx._bytes(b))
        assert a.untyped_storage().data_ptr() == rows.data_ptr()
    with pytest.raises(ValueError):
        sc_detect_rows(x, 32, 16, head=head, out=rows[:, :, 1:].contiguous())

    starts = torch.full((*x.shape[:-1], K), 100, dtype=torch.int32)
    F = SPEC.max_frame_len
    wins = torch.empty((*starts.shape, F), dtype=torch.complex64)
    assert gather_windows(x, starts, F, head=head, out=wins) is wins
    assert torch.equal(wins, gather_windows(x, starts, F, head=head))
    with pytest.raises(ValueError):
        gather_windows(x, starts, F - 1, head=head, out=wins)
