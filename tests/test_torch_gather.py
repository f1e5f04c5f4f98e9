"""The port's slot-window gather (plain version of the CUDA gather kernel)
against the JAX package's Pallas gathers in TPU interpret mode: exact
equality, including windows on both sides of and across the head/x seam.
The CUDA kernel itself is held against the plain version on the card by
chip_smoke.py."""

import numpy as np
import pytest
import torch

import jax
from jax.experimental.pallas import tpu as pltpu

from tpu_ofdm.kernels import gather as jg
from tpu_ofdm_torch.kernels import gather as tg


def _planes(n, seed):
    rng = np.random.RandomState(seed)
    return rng.randn(n).astype(np.float32), rng.randn(n).astype(np.float32)


def test_gather_matches_pallas_one_source():
    n, K, F = 1 << 17, 37, 1360
    re, im = _planes(n, 0)
    starts = np.sort(np.random.RandomState(1).randint(0, n - F, K)
                     ).astype(np.int32)
    starts[:2] = [0, n - F]
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(lambda a, b, s: jg.gather_windows(a, b, s, F))(
            re, im, starts)
    x = torch.complex(torch.as_tensor(re), torch.as_tensor(im))
    got = tg.gather_windows(x, torch.as_tensor(starts), F)
    assert got.dtype == torch.complex64 and got.shape == (K, F)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gather_matches_pallas_two_sources_across_seam():
    """The JAX two-source gather reads [head-region | x] with the head
    starting at virtual 0; the port reads [head | x] in place."""
    x_off, F, nx = 1 << 16, 1360, 1 << 17
    sup = jg.sup_rows_for(F) * 128
    vre, vim = _planes(x_off + nx, 2)
    starts = np.array([0, 5000, x_off - F - 7, x_off - 100, x_off - 1,
                       x_off, x_off + 3, x_off + nx - F], np.int32)
    with pltpu.force_tpu_interpret_mode():
        want = jax.jit(lambda hr, hi, xr, xi, s: jg.gather_windows_two(
            hr, hi, xr, xi, s, F, x_off=x_off))(
            vre[:x_off + sup].copy(), vim[:x_off + sup].copy(),
            vre[x_off:].copy(), vim[x_off:].copy(), starts)
    v = torch.complex(torch.as_tensor(vre), torch.as_tensor(vim))
    got = tg.gather_windows(v[x_off:].contiguous(), torch.as_tensor(starts),
                            F, head=v[:x_off].contiguous())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_gather_out_of_range_reads_zero():
    x = torch.arange(1, 11, dtype=torch.float32).to(torch.complex64)
    head = -torch.arange(1, 4, dtype=torch.float32).to(torch.complex64)
    before = tg.gather_windows.launches
    got = tg.gather_windows(x, torch.tensor([-2, 11, 0], dtype=torch.int32),
                            4, head=head)
    want = torch.tensor([[0, 0, -1, -2], [9, 10, 0, 0], [-1, -2, -3, 1]],
                        dtype=torch.complex64)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    assert tg.gather_windows.launches == before


# A torch model of csrc/gather.cu's index arithmetic.  Memory is addressed
# in samples: x, head and out each start 16-byte aligned (as the caching
# allocator places them), so an address is 16-byte aligned when it is even.
# The model classifies each window as the kernel does, runs its thread and
# unroll loops, asserts that every 16-byte load and store it issues is
# aligned, and counts the writes to each output sample.

THREADS, UNROLL = 256, 4   # csrc/gather.cu kThreads, kUnroll


def _loop_indices(count, per_thread):
    """The indices a CTA's `for (i0 = tid; i0 < count; i0 += THREADS *
    per_thread)` loop with `per_thread` unrolled slots visits, in order."""
    step = THREADS * per_thread
    t = torch.arange(THREADS)[:, None, None]
    u = torch.arange(per_thread)[None, :, None]
    p = torch.arange(max(1, -(-count // step)))[None, None, :]
    i0 = t + p * step
    i = i0 + u * THREADS
    return i[(i0 < count) & (i < count)]


def _model_copy(a0, d0, F):
    """copy_window: (output addresses, source addresses) of its stores."""
    lead = d0 % 2                         # aligned16(dst) ? 0 : 1
    pairs = (F - lead) // 2
    dst, src = [], []
    if lead:
        dst.append(torch.tensor([d0]))
        src.append(torch.tensor([a0]))
    if (F - lead) % 2:
        dst.append(torch.tensor([d0 + F - 1]))
        src.append(torch.tensor([a0 + F - 1]))
    s, d = a0 + lead, d0 + lead
    i = _loop_indices(pairs, UNROLL)
    assert (d + 2 * i).remainder(2).eq(0).all()     # float4 stores
    if s % 2 == 0:
        assert (s + 2 * i).remainder(2).eq(0).all()  # float4 loads
    for k in (0, 1):                                 # the pair's samples
        dst.append(d + 2 * i + k)
        src.append(s + 2 * i + k)
    return torch.cat(dst), torch.cat(src)


def _kernel_model_gather(x, starts, F, head=None):
    B = x.shape[0] if x.ndim == 2 else 1
    n = x.shape[-1]
    h = 0 if head is None else head.shape[-1]
    x_mem = x.reshape(-1)
    h_mem = None if head is None else head.reshape(-1)
    flat = starts.reshape(-1).to(torch.int64)
    out = torch.zeros(flat.numel() * F, dtype=torch.complex64)
    writes = torch.zeros(flat.numel() * F, dtype=torch.int64)
    classes = set()
    for w, s in enumerate(flat.tolist()):
        b, d0 = w // starts.shape[-1], w * F
        if s >= h and s + F <= h + n:
            classes.add("x")
            dst, src = _model_copy(b * n + s - h, d0, F)
            out[dst] = x_mem[src]
        elif s >= 0 and s + F <= h:
            classes.add("head")
            dst, src = _model_copy(b * h + s, d0, F)
            out[dst] = h_mem[src]
        else:
            classes.add("straddle")
            j = _loop_indices(F, 2 * UNROLL)
            p = s + j
            v = torch.zeros(len(j), dtype=torch.complex64)
            in_h = (p >= 0) & (p < h)
            in_x = (p >= h) & (p < h + n)
            if h:
                v[in_h] = h_mem[b * h + p[in_h]]
            v[in_x] = x_mem[b * n + p[in_x] - h]
            dst = d0 + j
            out[dst] = v
        writes[dst] += 1
    assert writes.eq(1).all()
    return out.reshape(*starts.shape, F), classes


def _model_starts(h, n, F, seed):
    """Starts of every class and both parities in [head h | x n]."""
    nv = h + n
    edge = [h, h + 1, nv - F, nv - F - 1, nv // 2, nv // 2 + 1]
    if h:
        edge += [0, 1, h - F, h - F - 1, h - F + 1, h - 1, h - F // 2]
    rng = np.random.RandomState(seed)
    rand = rng.randint(0, nv - F + 1, 12)
    return np.concatenate([edge, rand]).astype(np.int32)


def _outside_starts(nv, F):
    """Starts of windows that begin before 0 or run past the end."""
    return [-1, -F, -F - 3, -(F // 2), nv - F + 1, nv - 1, nv, nv + 5]


@pytest.mark.parametrize("F,B,h,n", [
    (2000, 1, 0, 1 << 14),         # one source, even F
    (1999, 1, 0, 1 << 14),         # one source, odd F
    (2000, 1, 3072, 1 << 15),      # [head | x], even F
    (1999, 1, 3072, 1 << 15),      # [head | x], odd F
    (720, 3, 3072, 1 << 14),       # batched, the wideband window
    (1999, 3, 3072, (1 << 14) + 3),  # batched, odd rows: both row parities
    (7, 2, 16, 1001),              # windows shorter than a thread's pairs
])
def test_kernel_index_model_matches_plain_and_pallas(F, B, h, n):
    """The kernel's window classes, odd leads, vector body and ragged last
    sample, modelled in torch, give gather_windows_plain bit for bit, every
    output sample written once; and, where the JAX Pallas gathers take the
    windows (inside the buffer, rows a multiple of 1024), their output."""
    rng = np.random.RandomState(F + n)
    v = (rng.randn(B, h + n) + 1j * rng.randn(B, h + n)).astype(np.complex64)
    head = torch.as_tensor(v[:, :h]) if h else None
    x = torch.as_tensor(v[:, h:])
    inside = _model_starts(h, n, F, seed=F)
    st = np.concatenate([inside, _outside_starts(h + n, F)]).astype(np.int32)
    starts = torch.as_tensor(np.stack([np.roll(st, b) for b in range(B)]))
    if B == 1:
        x, starts, head = x[0], starts[0], None if head is None else head[0]
    got, classes = _kernel_model_gather(x, starts, F, head)
    want = tg.gather_windows_plain(x, starts, F, head)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    assert classes == ({"x", "straddle"} | ({"head"} if h else set()))
    assert {int(s) % 2 for s in inside} == {0, 1}
    if n % 1024 or (h and h % 1024):
        return
    sup = jg.sup_rows_for(F) * 128
    two = jax.jit(lambda hr, hi, xr, xi, s: jg.gather_windows_two(
        hr, hi, xr, xi, s, F, x_off=h))
    one = jax.jit(lambda a, c, s: jg.gather_windows(a, c, s, F))
    got = got.reshape(B, len(st), F)
    for b in range(B):
        vb = np.concatenate([v[b], np.zeros(sup, np.complex64)])
        sb = np.roll(st, b)
        ok = (sb >= 0) & (sb <= h + n - F)
        with pltpu.force_tpu_interpret_mode():
            if h:
                jw = two(vb.real[:h + sup].copy(), vb.imag[:h + sup].copy(),
                         v[b, h:].real.copy(), v[b, h:].imag.copy(), sb[ok])
            else:
                jw = one(v[b].real.copy(), v[b].imag.copy(), sb[ok])
        np.testing.assert_array_equal(got[b][torch.as_tensor(ok)].numpy(),
                                      np.asarray(jw))


@pytest.mark.parametrize("bad", ["starts_dtype", "starts_2d", "x_dtype",
                                 "head_device"])
def test_gather_rejects_bad_inputs(bad):
    x = torch.zeros(64, dtype=torch.complex64)
    starts = torch.zeros(3, dtype=torch.int32)
    head = None
    if bad == "starts_dtype":
        starts = starts.to(torch.int64)
    elif bad == "starts_2d":
        starts = starts.reshape(3, 1)
    elif bad == "x_dtype":
        x = torch.zeros(64, dtype=torch.float32)
    else:
        head = torch.zeros(8, dtype=torch.complex64, device="meta")
    with pytest.raises((TypeError, ValueError)):
        tg.gather_windows(x, starts, 4, head=head)
