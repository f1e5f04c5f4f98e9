"""The table of peaks and the least time a stage's work can take.

A frozen copy of chip_smoke.py's `bound` arithmetic.  Work is counted from
the stage's shapes, not from the kernel that does it: each input byte read
once, and only what the stage hands on written once, so that a redesigned
or fused kernel is held to the same work.
"""

from __future__ import annotations

import math

# NVIDIA H100 SXM, published: HBM3 bandwidth, and float32 outside the
# tensor cores; both at the card's 700 W limit
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12


def least_seconds(nbytes: float, flops: float) -> float:
    """The larger of the bytes over the memory rate and the float32
    operations over the peak rate."""
    return max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)


# one detection handed on: start int32, fine CFO float32, peak float32,
# valid bool
DETECTION_BYTES = 13
# per sample: |v|^2, the lag product, the three window sums kept as running
# sums, the metric's ratio, the boxcar and the row maximum
DETECT_FLOPS_PER_SAMPLE = 25


def detect_seconds(buffers: int, samples: int, slots: int) -> float:
    """Schmidl-Cox detection over `buffers` virtual buffers of `samples`
    complex64 samples, handing on `slots` detections a buffer."""
    nbytes = buffers * (8 * samples + DETECTION_BYTES * slots)
    return least_seconds(nbytes, DETECT_FLOPS_PER_SAMPLE * buffers * samples)


def pfb_seconds(samples: int, channels: int, taps_per_arm: int) -> float:
    """The polyphase channelizer over `samples` complex64 input samples:
    each read once and its channel sample written once; a real FIR of
    taps_per_arm taps on every sample, then an FFT of `channels` points a
    row (5 N log2 N)."""
    flops = samples * (4 * taps_per_arm + 5 * math.log2(channels))
    return least_seconds(16 * samples, flops)
