"""The port's StreamExecutor and Block contract against the JAX package's:
tuple and NamedTuple pushes with every leaf checked, numpy pushes and runs
(64-bit numpy narrowed to 32-bit types, as JAX takes it), scan_blocks
against the JAX lax.scan driver, and Block.name / Block.__call__.  Values
at atol 1e-6 * max (1e-5 for the float32 scans)."""

import dataclasses
from typing import NamedTuple

import numpy as np
import pytest
import torch

import jax

from tpu_ofdm.stream import block as jb
from tpu_ofdm.stream import executor as jex
from tpu_ofdm.stream import graph as jg
from tpu_ofdm_torch.stream import block as tb
from tpu_ofdm_torch.stream import executor as tex
from tpu_ofdm_torch.stream import graph as tg


def _fan_in(B, G):
    fg = G.Flowgraph()
    fg.add("a", B.multiply_const(2.0)).add("b", B.multiply_const(3.0))
    fg.add("sum", B.stateless(lambda xy: xy[0] + xy[1], "add2"))
    fg.add_input("a").add_input("b")
    fg.connect("a", ("sum", 0)).connect("b", ("sum", 1))
    return fg.set_outputs("sum").build()


def test_tuple_push_matches_jax():
    rng = np.random.RandomState(0)
    x1, x2 = rng.randn(2, 64).astype(np.float32)
    want = jex.StreamExecutor(_fan_in(jb, jg), 64, donate=False).push((x1, x2))
    ex = tex.StreamExecutor(_fan_in(tb, tg), 64, device="cpu")
    got = ex.push((torch.as_tensor(x1), x2))      # a tensor and a numpy leaf
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-6)
    assert ex.samples_in == 64


def test_tuple_push_checks_every_leaf():
    ex = tex.StreamExecutor(_fan_in(tb, tg), 64, device="cpu")
    with pytest.raises(ValueError, match="expected 64"):
        ex.push((torch.zeros(64), torch.zeros(63)))
    with pytest.raises(ValueError, match="executor on cpu"):
        ex.push((torch.zeros(64), torch.zeros(64, device="meta")))


class _Pair(NamedTuple):
    re: torch.Tensor
    im: torch.Tensor


def test_namedtuple_push_keeps_its_type():
    blk = tb.stateless(lambda p: torch.complex(p.re, p.im), "join")
    ex = tex.StreamExecutor(blk, 8, device="cpu")
    got = ex.push(_Pair(np.arange(8.0), -np.arange(8.0)))
    assert got.dtype == torch.complex64
    np.testing.assert_array_equal(got.numpy(),
                                  np.arange(8.0) - 1j * np.arange(8.0))


def test_non_stream_input_skips_the_shape_check():
    blk = tb.Block(lambda d: (), lambda s, x: (s, x.sum()), stream_input=False)
    ex = tex.StreamExecutor(blk, 1024, device="cpu")
    assert float(ex.push(np.ones(3))) == 3.0


@pytest.mark.parametrize("dtype", [np.complex128, np.complex64, np.float64,
                                   np.int64])
def test_numpy_push_and_run_match_jax(dtype):
    """numpy in, as the apps feed it: converted on the executor's device
    to the 32-bit type JAX would make of it."""
    rng = np.random.RandomState(1)
    x = (rng.randn(1000) * 8).astype(dtype)
    if np.iscomplexobj(x):
        x = x + 1j * rng.randn(1000)
    jblk, tblk = jb.delay(5, dtype=np.complex64), tb.delay(5)
    want = np.concatenate([np.asarray(o) for o in jex.StreamExecutor(
        jblk, 256, donate=False).run(x, drain=True)])
    ex = tex.StreamExecutor(tblk, 256, device="cpu")
    got = torch.cat(ex.run(x, drain=True)).numpy()
    assert got.dtype == want.dtype == np.complex64
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    pushed = ex.push(x[:256])
    assert pushed.dtype == torch.complex64
    leaf = tex.to_device(x, "cpu")
    assert leaf.dtype == torch.from_numpy(
        np.zeros(1, jax.numpy.asarray(x).dtype)).dtype


@pytest.mark.parametrize("make,x", [
    (lambda B: B.moving_average(8),
     np.random.RandomState(4).randn(512).astype(np.float32)),
    (lambda B: B.head(300),
     (np.random.RandomState(5).randn(2, 512)
      + 1j * np.random.RandomState(6).randn(2, 512)).astype(np.complex64)),
], ids=["moving_average", "head_batched_tuple_out"])
def test_scan_blocks_matches_jax(make, x):
    """scan_blocks over (..., n_blocks, block_size): the final carry and
    every output leaf stacked over the blocks, as lax.scan gives them."""
    jblk, tblk = make(jb), make(tb)
    jblocks, _ = jex.pad_to_blocks(x, 64)
    js, jy = jex.scan_blocks(jblk, jblk.init(), jblocks)
    ts, ty = tex.scan_blocks(tblk, tblk.init("cpu"), jblocks, device="cpu")
    jl, tl = jax.tree.leaves(jy), tex.tree_leaves(ty)
    assert len(jl) == len(tl)
    assert isinstance(ty, tuple) == isinstance(jy, tuple)
    for a, b in zip(tl, jl):
        assert a.shape == b.shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=1e-5 * max(1, np.abs(b).max()))
    np.testing.assert_allclose(ts.numpy(), np.asarray(js), rtol=0,
                               atol=1e-5)
    # and the same as pushing the blocks one by one
    ex = tex.StreamExecutor(tblk, 64, device="cpu")
    one = [ex.push(b) for b in torch.as_tensor(jblocks).movedim(-2, 0)]
    for a, b in zip(tl, tex.tree_leaves(
            tex.tree_map(lambda *ys: torch.stack(ys), *one))):
        assert torch.equal(a, b)


def test_block_name_and_call():
    """Block.name defaults to "block" and is positional after apply, as in
    the JAX package; calling a Block runs its apply."""
    blk = tb.Block(lambda d: 0, lambda s, x: (s + 1, 2 * x))
    assert blk.name == "block" and blk.latency == 0 and blk.stream_input
    assert tb.Block(blk.init, blk.apply, "named").name == "named"
    assert blk(1, torch.ones(2))[0] == 2
    jblk = jb.Block(lambda: 0, lambda s, x: (s + 1, 2 * x))
    assert ([f.name for f in dataclasses.fields(tb.Block)]
            == [f.name for f in dataclasses.fields(jb.Block)])
    assert jblk.name == blk.name
    assert tb.stateless(abs).name == jb.stateless(abs).name == "fn"
    assert tb.chain(blk, blk).name == jb.chain(jblk, jblk).name == "chain"
