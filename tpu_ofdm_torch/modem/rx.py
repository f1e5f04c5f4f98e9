"""OFDM receiver: detect frames in a sample buffer and demodulate every
frame slot (counterpart of tpu_ofdm/modem/rx.py).

The static two-pass design of the JAX package carries over:

  pass 1: detect up to K frame starts (ops.sync.detect_frames),
  pass 2: gather a fixed-capacity window per slot (kernels.gather), derotate,
          FFT the whole frame, estimate/equalize, parse the header, demap
          the payload bytes under masks derived from the header length.

Where JAX vmapped a one-frame `demod_frame` over the slots, `demod_frame`
here is written for a batch (K, ...) of slots; every reduction runs over
one slot's own axes.  Everything is fixed capacity plus validity masks, so
the whole block is enqueued on the device without waiting on the host, and
on the card the torch-op chains of a step shape are captured once as CUDA
graphs and replayed (StepGraphs).

`equalizer` is "pilot_phase" (the default) or "simpledfe"; `output` is
"hard" (the default) or "soft", which adds max-log LLRs of the payload bits
scaled by each frame's post-equalization noise estimate (EVM^2), computed
on the device.

rx_block also takes a batch of B buffers (B, n) -- the wideband receiver's
channels, which the JAX package vmaps over -- and then every result field
leads with (B, K).
"""

from __future__ import annotations

import collections
import contextlib
import functools
import threading
import weakref
from typing import NamedTuple

import torch

from tpu_ofdm_torch.config import HEADER_BITS, OfdmSpec
from tpu_ofdm_torch.kernels.gather import gather_windows
from tpu_ofdm_torch.ops import carrier_alloc
from tpu_ofdm_torch.ops.chanest import coarse_int_cfo, ls_estimate, roll_bins
from tpu_ofdm_torch.ops.constellation import demap_hard, demap_soft
from tpu_ofdm_torch.ops.constellation import evm as evm_op
from tpu_ofdm_torch.ops.crc import check_crc32
from tpu_ofdm_torch.ops.equalizer import (equalize_pilot_phase,
                                          equalize_simpledfe)
from tpu_ofdm_torch.ops.header import parse_header_bits
from tpu_ofdm_torch.kernels.sc_detect import ROW
from tpu_ofdm_torch.ops.sync import (Detections, derotate, detect_rows,
                                     select_frames)
from tpu_ofdm_torch.ops.transform import ofdm_fft
from tpu_ofdm_torch.utils import metrics
from tpu_ofdm_torch.utils.bits import bits_to_bytes


class FrameResult(NamedTuple):
    payload: torch.Tensor      # (K, max_payload_bytes) uint8 wire bytes (incl CRC)
    payload_len: torch.Tensor  # (K,) int32: payload bytes EXCL. CRC32 (wire-4)
    frame_num: torch.Tensor    # (K,) int32
    hdr_ok: torch.Tensor       # (K,) bool: header CRC8 passed
    crc_ok: torch.Tensor       # (K,) bool: payload CRC32 passed
    evm: torch.Tensor          # (K,) float32: payload EVM vs hard decisions
    int_cfo: torch.Tensor      # (K,) int32
    data_syms: torch.Tensor    # (K, sym_capacity) complex64 equalized payload
    sym_mask: torch.Tensor     # (K, sym_capacity) bool: valid payload symbols
    sync_q: torch.Tensor       # (K,) float32: sync1 spectral-support quality
    sync_ok: torch.Tensor      # (K,) bool: sync_q above acquisition threshold
    llr: torch.Tensor          # (K, sym_capacity*bps) float32 max-log LLRs of
    #   the payload bits (positive => bit 0; 0 beyond the wire bits), scaled
    #   by the frame's EVM^2; (K, 0) when output="hard"


@functools.lru_cache(maxsize=64)
def _bins(spec: OfdmSpec, device: torch.device):
    return (torch.as_tensor(spec.sync1_bins, device=device),
            torch.as_tensor(spec.occupied_bins, device=device))


EQUALIZERS = ("pilot_phase", "simpledfe")
OUTPUTS = ("hard", "soft")


def _check_options(equalizer: str, output: str) -> None:
    if equalizer not in EQUALIZERS or output not in OUTPUTS:
        raise ValueError(f"equalizer {equalizer!r} / output {output!r}: "
                         f"expected one of {EQUALIZERS} / {OUTPUTS}")


def demod_frame(spec: OfdmSpec, frames: torch.Tensor,
                equalizer: str = "pilot_phase",
                output: str = "hard") -> FrameResult:
    """Demodulate a batch of start-aligned, CFO-derotated frame windows
    (K, >= max_frame_len) complex64.

    frames[k, 0] is the detected FFT-window start of sync word 1 (a few
    samples inside its CP; the circular shift this causes is absorbed into
    the channel estimate as a linear phase)."""
    _check_options(equalizer, output)
    K = frames.shape[0]
    dev = frames.device
    n_syms = spec.max_frame_ofdm_syms
    wins = frames[:, : n_syms * spec.sym_len].reshape(K, n_syms, spec.sym_len)
    grids = ofdm_fft(wins[..., : spec.fft_len])                 # (K, S, N)

    ic = coarse_int_cfo(spec, grids[:, 0])                      # (K,)
    grids = roll_bins(grids, ic)                                # undo +ic shift

    # Frame-acquisition gate: sync word 1 occupies ONLY the even occupied
    # bins, so symbol-0 energy concentrated there (~1) separates a true
    # preamble from a mid-frame or noise window (~0.5).
    s1_bins, occ_bins = _bins(spec, dev)
    g0 = grids[:, 0]
    e_on = (g0[:, s1_bins].abs() ** 2).sum(-1)
    e_occ = (g0[:, occ_bins].abs() ** 2).sum(-1)
    sync_q = e_on / e_occ.clamp(min=1e-12)
    sync_ok = (sync_q > 0.75) & (e_occ > 1e-9)

    H = ls_estimate(spec, grids[:, 1])                          # (K, N)

    hdr_eq = equalize_pilot_phase(spec, grids[:, 2:3], H)       # (K, 1, N)
    hdr_syms = carrier_alloc.serialize(spec, hdr_eq)            # (K, n_data)
    hdr_bits = demap_hard(hdr_syms[:, :HEADER_BITS], "bpsk")
    wire_len, fnum, hdr_ok = parse_header_bits(hdr_bits)
    cap = spec.max_payload_bytes
    wire_len = wire_len.clamp(0, cap)

    equalize = (equalize_simpledfe if equalizer == "simpledfe"
                else equalize_pilot_phase)
    pay_eq = equalize(spec, grids[:, 3:], H)                    # (K, P, N)
    syms = carrier_alloc.serialize(spec, pay_eq)                # (K, sym_cap)

    bps = spec.bits_per_symbol
    wire_bits = wire_len[:, None] * 8
    n_mod_syms = (wire_bits + bps - 1) // bps
    sym_cap = syms.shape[1]
    sym_mask = torch.arange(sym_cap, device=dev) < n_mod_syms

    bits = demap_hard(syms, spec.modulation)                    # (K, sym_cap*bps)
    bits = torch.where(torch.arange(bits.shape[1], device=dev) < wire_bits,
                       bits, 0)
    wire = bits_to_bytes(bits)[:, :cap]
    wire = torch.where(torch.arange(cap, device=dev) < wire_len[:, None],
                       wire, 0)

    crc_ok = check_crc32(wire, wire_len) & hdr_ok & sync_ok
    e = evm_op(syms, spec.modulation, mask=sym_mask)

    if output == "soft":
        noise_var = (e.to(torch.float32) ** 2).clamp(min=1e-6)
        llr = demap_soft(syms, spec.modulation, noise_var)
        llr = torch.where(torch.arange(llr.shape[1], device=dev) < wire_bits,
                          llr, 0.0)
    else:
        llr = torch.zeros((K, 0), dtype=torch.float32, device=dev)

    return FrameResult(
        payload=wire,
        payload_len=(wire_len - 4).clamp(min=0),
        frame_num=fnum,
        hdr_ok=hdr_ok,
        crc_ok=crc_ok,
        evm=e.to(torch.float32),
        int_cfo=ic,
        data_syms=syms,
        sym_mask=sym_mask,
        sync_q=sync_q.to(torch.float32),
        sync_ok=sync_ok,
        llr=llr,
    )


class RxBlockResult(NamedTuple):
    frames: FrameResult      # batched over ([B,] K) slots
    starts: torch.Tensor     # ([B,] K) int32 start index in the virtual buffer
    fine_cfo: torch.Tensor   # ([B,] K) float32
    valid: torch.Tensor      # ([B,] K) bool: slot holds an accepted detection


class _Selected(NamedTuple):
    det: Detections
    gstart: torch.Tensor     # ([B,] K) int32 window starts, clamped in range


def _select(spec: OfdmSpec, rows6, nv: int, max_frames: int) -> _Selected:
    """The detection's selection over sc_detect's row summaries, and the
    starts the slot windows are gathered at."""
    det = select_frames(spec, rows6, nv, max_frames)
    # clamp so invalid slots still gather in range
    return _Selected(det, det.start.clamp(0, max(nv - spec.max_frame_len,
                                                 0)))


def _demod(spec: OfdmSpec, wins: torch.Tensor, sel: _Selected, own_lo: int,
           own_hi: int, equalizer: str, output: str) -> RxBlockResult:
    """Demodulate the gathered slot windows ([B,] K, F) of the detections
    `sel`; accept those in the ownership window."""
    det = sel.det
    owned = det.valid & (det.start >= own_lo) & (det.start < own_hi)
    wins = derotate(wins, det.fine_cfo, spec.fft_len)
    lead = wins.shape[:-1]                      # ([B,] K)
    flat = demod_frame(spec, wins.reshape(-1, spec.max_frame_len), equalizer,
                       output)
    frames = FrameResult(*(f.reshape(*lead, *f.shape[1:]) for f in flat))
    # a slot is valid only if owned AND acquisition confirmed AND header ok
    valid = owned & frames.sync_ok & frames.hdr_ok
    return RxBlockResult(frames, det.start, det.fine_cfo, valid)


def rx_block(
    spec: OfdmSpec,
    x: torch.Tensor,
    max_frames: int,
    own_lo: int = 0,
    own_hi: int | None = None,
    head: torch.Tensor | None = None,
    equalizer: str = "pilot_phase",
    output: str = "hard",
) -> RxBlockResult:
    """Detect and demodulate up to `max_frames` frames in the virtual
    buffer [head | x] (complex64; x (n,) with head (h,), or a batch x
    (B, n) with head (B, h); head None for x alone), without building the
    concatenation: detection and the slot-window gather both read the two
    pieces in place.  Same semantics as the JAX rx_block on
    concat([head, x]) (vmapped over the batch); all positions are virtual
    coordinates.

    Ownership window [own_lo, own_hi): only detections whose start falls in
    it are accepted (the streaming receiver's exactly-once rule).
    `equalizer` and `output` as in demod_frame.

    On the card the step replays its captured CUDA graphs (STEP_GRAPHS);
    every tensor it returns is its own, never a graph's buffer.  Spans
    "rx.detect" and "rx.demod"; counters "rx.slots", and on the card
    "rx.graph_replay" or "rx.graph_eager"."""
    _check_options(equalizer, output)
    if own_hi is None:
        own_hi = x.shape[-1] + (0 if head is None else head.shape[-1])
    res = STEP_GRAPHS.run(spec, x, max_frames, own_lo, own_hi, head,
                          equalizer, output)
    metrics.count("rx.slots", res.valid.numel())
    return res


def rx_block_eager(spec: OfdmSpec, x: torch.Tensor, max_frames: int,
                   own_lo: int, own_hi: int, head: torch.Tensor | None,
                   equalizer: str, output: str) -> RxBlockResult:
    """rx_block's step enqueued op by op (arguments as rx_block's, own_hi
    given): what the CPU runs, and the card where the step is not
    replayed."""
    nv = x.shape[-1] + (0 if head is None else head.shape[-1])
    with metrics.span("rx.detect"):
        sel = _select(spec, detect_rows(spec, x, head), nv, max_frames)
    with metrics.span("rx.demod"):
        wins = gather_windows(x, sel.gstart, spec.max_frame_len, head=head)
        return _demod(spec, wins, sel, own_lo, own_hi, equalizer, output)


# --- the step as CUDA graphs -------------------------------------------------
#
# Enqueued op by op, the selection and the demod are ~275 torch ops a step
# whatever the number of frames, and the host's enqueuing of them, not the
# card, sets the step's pace.  On the card each step shape captures the two
# chains once as CUDA graphs and replays them.  sc_detect and gather stay
# eager launches between the replays, as they read the caller's block and
# history by pointer, which change every call: sc_detect writes into the
# selection graph's input buffer, gather into the demod graph's.  The
# demod graph packs every output into one flat byte buffer, which each call
# copies out once, so a later replay cannot overwrite what an earlier call
# returned, and marks with an event on the stream (step_mark), so that the
# sink can read that copy back without waiting for what is queued after it.


def _leaves(res: RxBlockResult) -> list[torch.Tensor]:
    return [*res.frames, res.starts, res.fine_cfo, res.valid]


# the leaves in the order of their place in the flat buffer: first what the
# sink (modem/sink.py) reads of a step, so that one copy of one span of
# bytes brings it to the host; then what it never reads
_NAMES = (*FrameResult._fields, *RxBlockResult._fields[1:])   # _leaves'
_PLACED = [_NAMES.index(name) for name in (
    "valid", "payload", "payload_len", "frame_num", "hdr_ok", "crc_ok",
    "evm", "int_cfo", "starts", "fine_cfo", "llr",
    "data_syms", "sym_mask", "sync_q", "sync_ok")]


def _from_leaves(leaves: list[torch.Tensor]) -> RxBlockResult:
    n = len(FrameResult._fields)
    return RxBlockResult(FrameResult(*leaves[:n]), *leaves[n:])


def _bytes(t: torch.Tensor) -> torch.Tensor:
    """t's bytes, as a flat uint8 view (of a contiguous copy, where t is
    not contiguous)."""
    t = t.contiguous()
    if t.is_complex():
        t = torch.view_as_real(t)
    return t.reshape(-1).view(torch.uint8)


class _Layout:
    """Where each of a step's output tensors (_leaves' list) lies in the
    flat byte buffer: in _PLACED's order, each at an offset aligned to
    ALIGN bytes, in a buffer a multiple of ALIGN bytes long, so that the
    buffer views as each dtype and each tensor is a strided view of one of
    those."""

    ALIGN = 16

    def __init__(self, leaves: list[torch.Tensor]):
        # (byte offset, bytes, dtype, shape, stride), in leaves' order
        self.fields = [None] * len(leaves)
        off = 0
        for i in _PLACED:
            t = leaves[i]
            n = t.numel() * t.element_size()
            stride = torch.empty(t.shape, device="meta").stride()
            self.fields[i] = (off, n, t.dtype, t.shape, stride)
            off += -(-n // self.ALIGN) * self.ALIGN
        self.nbytes = off
        self.dtypes = {t.dtype for t in leaves}

    def pack(self, leaves: list[torch.Tensor], flat: torch.Tensor) -> None:
        """Copy the leaves into `flat`, all as bytes in one foreach copy."""
        dst, src = [], []
        for (off, n, *_), t in zip(self.fields, leaves):
            if n:
                dst.append(flat[off:off + n])
                src.append(_bytes(t))
        torch._foreach_copy_(dst, src)

    def unpack(self, flat: torch.Tensor) -> list[torch.Tensor]:
        """The leaves as views of `flat` (the fewest host ops: one view a
        dtype, one as_strided a leaf)."""
        typed = {dtype: flat.view(dtype) for dtype in self.dtypes}
        return [typed[dtype].as_strided(shape, stride, off // dtype.itemsize)
                for off, _, dtype, shape, stride in self.fields]


class _Step:
    """One step shape's two graphs and their static buffers."""

    def __init__(self, calls: "CudaGraphCalls", spec: OfdmSpec,
                 x: torch.Tensor, max_frames: int,
                 head: torch.Tensor | None):
        self.calls, self.spec = calls, spec
        self.nv = x.shape[-1] + (0 if head is None else head.shape[-1])
        batch = x.shape[:-1]
        B = batch[0] if batch else 1
        self.rows = torch.empty((6, B, -(-self.nv // ROW)),
                                dtype=torch.float32, device=x.device)
        self.wins = torch.empty((*batch, max_frames, spec.max_frame_len),
                                dtype=torch.complex64, device=x.device)

    def capture(self, x, max_frames, own_lo, own_hi, head, equalizer,
                output) -> RxBlockResult:
        """Run the step once, eagerly, on the capture stream (the warm-up
        torch.cuda.graphs prescribes; this call's result), then capture
        its two chains."""
        spec, calls, dev = self.spec, self.calls, x.device
        demod = (own_lo, own_hi, equalizer, output)
        with calls.side(dev):
            with metrics.span("rx.detect"):
                rows6 = detect_rows(spec, x, head, out=self.rows)
                sel = _select(spec, rows6, self.nv, max_frames)
            with metrics.span("rx.demod"):
                gather_windows(x, sel.gstart, spec.max_frame_len, head=head,
                               out=self.wins)
                res = _demod(spec, self.wins, sel, *demod)
        leaves = _leaves(res)
        calls.keep(leaves, dev)
        self.layout = _Layout(leaves)
        self.flat = torch.empty(self.layout.nbytes, dtype=torch.uint8,
                                device=dev)
        with calls.side(dev):
            self.sel_graph, self.sel = calls.capture(
                lambda: _select(spec, rows6, self.nv, max_frames))
            self.demod_graph, _ = calls.capture(
                lambda: self.layout.pack(
                    _leaves(_demod(spec, self.wins, self.sel, *demod)),
                    self.flat),
                pool=self.sel_graph.pool())
        return res

    def replay(self, x, head) -> RxBlockResult:
        with metrics.span("rx.detect"):
            detect_rows(self.spec, x, head, out=self.rows)
            self.sel_graph.replay()
        with metrics.span("rx.demod"):
            gather_windows(x, self.sel.gstart, self.spec.max_frame_len,
                           head=head, out=self.wins)
            self.demod_graph.replay()
            record = self.flat.clone()
            _MARKS[record.untyped_storage()] = (self.calls,
                                               self.calls.mark(x.device))
            return _from_leaves(self.layout.unpack(record))


# a replayed step's record (the storage its result views) -> (the calls
# that replayed it, an event recorded on the stream after the record was
# written): its sink may read the record back once that event has passed,
# not after whatever the stream queued since (step_mark)
_MARKS: weakref.WeakKeyDictionary = weakref.WeakKeyDictionary()


def step_mark(t: torch.Tensor):
    """(calls, event) where t views a replayed step's record, else None."""
    return _MARKS.get(t.untyped_storage())


class CudaGraphCalls:
    """The CUDA calls the step's graphs rest on; the tests stand a CPU
    version in."""

    def __init__(self):
        self._side: dict[torch.device, torch.cuda.Stream] = {}
        self._readback: dict[torch.device, torch.cuda.Stream] = {}

    def usable(self, x: torch.Tensor) -> bool:
        """Whether the step on x may capture and replay: on the card, and
        not inside another capture."""
        return (x.device.type == "cuda"
                and not torch.cuda.is_current_stream_capturing())

    def stream(self, dev: torch.device) -> int:
        """The current stream of `dev`."""
        return torch._C._cuda_getCurrentRawStream(dev.index)

    @contextlib.contextmanager
    def side(self, dev: torch.device):
        """Work on dev's side stream, ordered after the current stream's
        work queued so far and before what it queues next."""
        cur = torch.cuda.current_stream(dev)
        side = self._side.get(dev)
        if side is None:
            side = self._side[dev] = torch.cuda.Stream(dev)
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            yield
        cur.wait_stream(side)

    def capture(self, fn, pool=None):
        """(graph, fn's output) from capturing fn on the current stream;
        only this thread's calls may break the capture."""
        graph = torch.cuda.CUDAGraph()
        graph.capture_begin(pool=pool, capture_error_mode="thread_local")
        try:
            out = fn()
        finally:
            graph.capture_end()
        return graph, out

    def keep(self, tensors: list[torch.Tensor], dev: torch.device) -> None:
        """Tensors made on the side stream, handed to the current one."""
        cur = torch.cuda.current_stream(dev)
        for t in tensors:
            t.record_stream(cur)

    def mark(self, dev: torch.device) -> torch.cuda.Event:
        """An event recorded on dev's current stream, after the work
        queued on it so far."""
        event = torch.cuda.Event()
        event.record(torch.cuda.current_stream(dev))
        return event

    def read(self, event, record: torch.Tensor, index: torch.Tensor | None):
        """(host record, host index, done): `record` (flat uint8) and
        `index` (a () tensor, or None) copied into one fresh pinned host
        buffer on record's device's readback stream once `event` has
        passed, and `done`, an event recorded there after the copies: the
        host waits on it alone, not on what the current stream queued
        after `event`."""
        dev = record.device
        stream = self._readback.get(dev)
        if stream is None:
            stream = self._readback[dev] = torch.cuda.Stream(dev)
        rec, host = host_buffer(record, index, pin_memory=True)
        with torch.cuda.stream(stream):
            stream.wait_event(event)
            rec.copy_(record, non_blocking=True)
            if index is not None:
                host.copy_(index, non_blocking=True)
            done = torch.cuda.Event()
            done.record(stream)
        return rec, host, done


def host_buffer(record: torch.Tensor, index: torch.Tensor | None,
                pin_memory: bool = False):
    """(host record, host index): views of one fresh host byte buffer for
    `record`'s bytes and, at the next multiple of 16 bytes, `index`'s (of
    its dtype and shape; None without an index)."""
    at = -(-record.numel() // 16) * 16
    n = 0 if index is None else index.numel() * index.element_size()
    buf = torch.empty(at + n, dtype=torch.uint8, pin_memory=pin_memory)
    host = (None if index is None
            else buf[at:].view(index.dtype).reshape(index.shape))
    return buf[:record.numel()], host


_WARMED = "warmed"   # a key's first call ran eagerly; the next captures


class StepGraphs:
    """rx_block's captured steps, by step shape: spec, options, x's and
    head's shapes, max_frames, the ownership window, the device and its
    current stream (so that steps on other streams share no buffer).  The
    first call of a key runs eagerly on the current stream and builds the
    constants and FFT plans; the second runs on a side stream and captures;
    later calls replay.  The `size` keys used last are kept."""

    def __init__(self, size: int = 8, calls: CudaGraphCalls | None = None):
        self.size = size
        self.calls = CudaGraphCalls() if calls is None else calls
        self.steps: collections.OrderedDict = collections.OrderedDict()
        # a step's buffers serve one call at a time
        self._lock = threading.Lock()

    def run(self, spec, x, max_frames, own_lo, own_hi, head, equalizer,
            output) -> RxBlockResult:
        args = (max_frames, own_lo, own_hi, head, equalizer, output)
        if not self.calls.usable(x):
            if x.device.type == "cuda":
                metrics.count("rx.graph_eager")
            return rx_block_eager(spec, x, *args)
        key = (spec, equalizer, output, tuple(x.shape),
               None if head is None else tuple(head.shape), max_frames,
               own_lo, own_hi, x.device, self.calls.stream(x.device))
        with self._lock:
            step = self.steps.pop(key, None)
            if isinstance(step, _Step):
                self.steps[key] = step
                metrics.count("rx.graph_replay")
                return step.replay(x, head)
            metrics.count("rx.graph_eager")
            if step is None:
                res = rx_block_eager(spec, x, *args)
                self.steps[key] = _WARMED
            else:
                step = _Step(self.calls, spec, x, max_frames, head)
                res = step.capture(x, *args)
                self.steps[key] = step
            while len(self.steps) > self.size:
                self.steps.popitem(last=False)
            return res


STEP_GRAPHS = StepGraphs()
