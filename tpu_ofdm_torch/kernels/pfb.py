"""Polyphase filterbank channelizer: CUDA kernel (csrc/pfb.cu) and its plain
version.

Counterpart of tpu_ofdm/kernels/pfb.py (`channelize_fused`, over both
`_pfb_pallas` and `_pfb_pallas_wide`).  `channelize_fused(x, poly, tail)`
channelizes a flat complex64 stream x (n,), n % N == 0, with the polyphase
matrix poly (J, N) float32 (spectrum.channelizer.polyphase_decompose) and
the raw samples that precede x (`tail`, None for zeros at stream start):

    out[m, k] = sum_a z[m, a] exp(+2 pi i a k / N)              (n/N, N)
    z[m, a]   = sum_j poly[j, a] * [tail | x][C + (m-j) N + (N-1-a)]

which is `channelize_ext`'s ifft(acc) * N on the lane-reversed commutator
rows (arm a consumes x[mN + (N-1-a)]).  The tail carry keeps the JAX length
`tail_len` so a carry saved by either package resumes in the other; the FIR
reads only its last (J-1) N samples.  CUDA tensors launch the kernel; CPU
tensors take `channelize_fused_plain`.

`layout` is the consumer's: "row" gives out as above, (n/N, N); "chan" its
transpose, (N, n/N) channel-major, bit for bit, which the kernel writes
through its channel-major store (`pfb_chan_launch`) and the plain version
as `.t().contiguous()` of its rows.
"""

from __future__ import annotations

import torch

from tpu_ofdm_torch.kernels.build import check_vector, complex_ptr, library
from tpu_ofdm_torch.utils import metrics

LANE = 128  # the JAX kernel's carry granularity
# output layout -> the kernel's C entry point
LAUNCH = {"row": "pfb_launch", "chan": "pfb_chan_launch"}


def tail_len(n_chan: int, taps_per_arm: int) -> int:
    """Streaming-carry length in raw samples: the FIR lookback (J-1)*N
    rounded up to whole 128-sample rows (the JAX kernel's ring granularity,
    kept so that carries are interchangeable)."""
    return (((taps_per_arm - 1) * n_chan) // LANE + 1) * LANE


def supported(n_chan: int) -> bool:
    """The channel counts the JAX package's fused kernels cover (n_chan <=
    128 dividing 128, or a multiple of 128 up to 512); the others take the
    plain chain, as they take the XLA chain there."""
    if n_chan <= LANE:
        return LANE % n_chan == 0
    return n_chan % LANE == 0 and n_chan <= 512


def commutator_rows(x: torch.Tensor, n_chan: int) -> torch.Tensor:
    """Serial samples -> lane-reversed commutator rows (..., n, n_chan)."""
    n_out = x.shape[-1] // n_chan
    rows = x[..., : n_out * n_chan].reshape(*x.shape[:-1], n_out, n_chan)
    return rows.flip(-1)


def channelize_ext(ext_rows: torch.Tensor, poly: torch.Tensor) -> torch.Tensor:
    """Channelize history-extended commutator rows (..., n_out + J - 1, N),
    whose first J-1 rows are history: a causal J-tap FIR per arm as shifted
    multiply-adds, then the cross-arm IDFT, ifft(acc) * N."""
    J, n_chan = poly.shape
    n_out = ext_rows.shape[-2] - (J - 1)
    acc = torch.zeros((*ext_rows.shape[:-2], n_out, n_chan),
                      dtype=torch.complex64, device=ext_rows.device)
    for j in range(J):
        acc = acc + poly[j] * ext_rows[..., J - 1 - j: J - 1 - j + n_out, :]
    return torch.fft.ifft(acc) * n_chan


def channelize_fused_plain(x: torch.Tensor, poly: torch.Tensor,
                           tail: torch.Tensor | None = None,
                           layout: str = "row") -> torch.Tensor:
    """Plain PyTorch version of `channelize_fused` (same arguments)."""
    J, N = poly.shape
    k = (J - 1) * N
    if tail is None:
        hist = x.new_zeros(k)
    else:
        hist = tail[tail.shape[-1] - k:]
    rows = commutator_rows(torch.cat([hist, x]), N)
    out = channelize_ext(rows, poly)
    return out.t().contiguous() if layout == "chan" else out


def channelize_fused(x: torch.Tensor, poly: torch.Tensor,
                     tail: torch.Tensor | None = None,
                     layout: str = "row") -> torch.Tensor:
    """(n // N, N) complex64 channel rows of x (n,) complex64 (see the
    module docstring), or with layout "chan" their (N, n // N) transpose;
    tail: >= (J-1)*N complex64 samples preceding x.  Counters "pfb.row"
    and "pfb.chan": one a call, under its layout."""
    if layout not in LAUNCH:
        raise ValueError(f"channelize_fused: layout {layout!r}, expected "
                         f"one of {sorted(LAUNCH)}")
    check_vector(x, "x", torch.complex64)
    check_vector(poly, "poly", torch.float32, x.device, ndims=(2,))
    J, N = poly.shape
    if not supported(N):
        raise ValueError(f"channelize_fused: {N} channels not supported")
    n = x.shape[0]
    if n % N:
        raise ValueError(f"{n} samples is not a multiple of {N} channels")
    if tail is not None:
        check_vector(tail, "tail", torch.complex64, x.device)
        if tail.shape[0] < (J - 1) * N:
            raise ValueError(f"tail of {tail.shape[0]} samples, the FIR "
                             f"needs {(J - 1) * N}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"channelize_fused: unsupported device {x.device}")
    if metrics.enabled():
        metrics.count("pfb." + layout)
    if x.device.type == "cpu":
        return channelize_fused_plain(x, poly, tail, layout)
    shape = (N, n // N) if layout == "chan" else (n // N, N)
    out = torch.empty(shape, dtype=torch.complex64, device=x.device)
    h = 0 if tail is None else tail.shape[0]
    library().launch(
        LAUNCH[layout], x.device, complex_ptr(tail), h, complex_ptr(x), n,
        poly.data_ptr(), J, N, complex_ptr(out),
    )
    channelize_fused.launches += 1
    channelize_fused.forms[layout] += 1
    return out


channelize_fused.launches = 0  # kernel launches since the last reset
channelize_fused.forms = {"row": 0, "chan": 0}  # by layout
