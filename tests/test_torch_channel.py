"""The port's channel models against the JAX package's.

Without noise the two agree to float32 rounding of the CFO rotation: atol
1e-6 on one short block, 5e-6 where blocks carry the phase (float32 cos and
sin of phases up to ~12 rad round differently in XLA and torch).  Cutting a
stream into blocks moves either package's output by up to 6.5e-6 (the
carry rounds w * block_len once per block), so chunk invariance is held to
1e-5.  With noise they are held by statistics: jax.random's bits cannot be drawn
in torch, so the noise's mean and power must land within a few percent of
the target.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from tpu_ofdm.config import OfdmConfig
from tpu_ofdm_torch import config as tconfig
from tpu_ofdm.ops import channel as jch
from tpu_ofdm.stream import executor as jex
from tpu_ofdm_torch.ops import channel as tch
from tpu_ofdm_torch.stream import executor as tex

TAPS = [1.0, 0.3 - 0.2j, 0.0, 0.1j]


def _signal(n, seed=0, batch=()):
    rng = np.random.RandomState(seed)
    return ((rng.randn(*batch, n) + 1j * rng.randn(*batch, n)) / np.sqrt(2)
            ).astype(np.complex64)


@pytest.mark.parametrize("batch", [(), (3,)])
def test_impairments_match_jax(batch):
    x = _signal(3000, batch=batch)
    tx = torch.as_tensor(x)
    np.testing.assert_allclose(tch.apply_cfo(tx, 0.37, 64, 0.5).numpy(),
                               np.asarray(jch.apply_cfo(jnp.asarray(x), 0.37,
                                                        64, 0.5)), atol=1e-6)
    np.testing.assert_allclose(tch.multipath(tx, TAPS).numpy(),
                               np.asarray(jch.multipath(jnp.asarray(x), TAPS)),
                               atol=1e-6)
    np.testing.assert_array_equal(
        tch.timing_offset(tx, 17).numpy(),
        np.asarray(jch.timing_offset(jnp.asarray(x), 17)))
    assert tch.timing_offset(tx, 0) is tx


def test_channel_model_without_noise_matches_jax():
    x = _signal(5000, seed=1)
    got = tch.channel_model(None, torch.as_tensor(x), cfo=-0.21, taps=TAPS,
                            delay=9, phase=1.0)
    want = jch.channel_model(jax.random.PRNGKey(0), jnp.asarray(x), cfo=-0.21,
                             taps=TAPS, delay=9, phase=1.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-6)


@pytest.mark.parametrize("taps", [None, TAPS])
def test_channel_block_without_noise_is_chunk_invariant(taps):
    """Blocks of 1024 through the port, the JAX block on the same chunks,
    and one channel_model pass over the whole stream agree."""
    x = _signal(8 * 1024, seed=2)
    kw = dict(cfo=0.05, fft_len=64, taps=taps, phase=0.3)
    got = tex.StreamExecutor(tch.channel_block(**kw), 1024,
                             device="cpu").run(
        torch.as_tensor(x))
    got = torch.cat(got).numpy()
    want = np.concatenate([np.asarray(b) for b in jex.StreamExecutor(
        jch.channel_block(**kw), 1024).run(x)])
    np.testing.assert_allclose(got, want, atol=5e-6)
    whole = tch.channel_model(None, torch.as_tensor(x), cfo=0.05, taps=taps,
                              phase=0.3).numpy()
    np.testing.assert_allclose(got, whole, atol=1e-5)


def test_channel_block_resumes_from_a_jax_carry():
    """Two JAX steps, then the port continues from the JAX carry; its third
    step equals JAX's third step (no noise)."""
    x = _signal(3 * 1024, seed=3)
    kw = dict(cfo=0.11, taps=TAPS)
    jx = jex.StreamExecutor(jch.channel_block(**kw), 1024)
    outs = jx.run(x)
    jy = jex.StreamExecutor(jch.channel_block(**kw), 1024)
    jy.run(x[:2048])
    blk = tch.channel_block(**kw)
    state = tch.carry_from_jax(jax.tree.map(np.asarray, jy.state), "cpu")
    _, y = blk.apply(state, torch.as_tensor(x[2048:]))
    np.testing.assert_allclose(y.numpy(), np.asarray(outs[2]), atol=5e-6)


def test_awgn_statistics():
    """channel_block at 10 dB against the "ofdm" signal power on a silent
    stream: the noise's mean is 0 and its power 1/10 of the signal power,
    each within 2% of the noise's rms over 2^18 samples; the stream is a
    function of the seed."""
    sig = tch.ofdm_signal_power(tconfig.OfdmConfig(fft_len=64).spec)
    assert sig == jch.ofdm_signal_power(OfdmConfig(fft_len=64).spec)
    z = torch.zeros(1 << 18, dtype=torch.complex64)

    def noise(seed):
        blk = tch.channel_block(seed=seed, snr_db=10.0, cfo=0.1)
        return blk.apply(blk.init("cpu"), z)[1]

    y = noise(4)
    want = sig / 10
    assert abs((y.abs() ** 2).mean().item() / want - 1) < 0.02
    assert abs(y.mean().item()) < 0.02 * want ** 0.5
    assert abs(y.real.var().item() / y.imag.var().item() - 1) < 0.02
    torch.testing.assert_close(y, noise(4), rtol=0, atol=0)
    assert not torch.equal(y, noise(5))


def test_channel_model_noise_against_the_clean_power():
    """channel_model sizes its noise against the clean input's power, as
    the JAX package does: the JAX and port noise powers agree within 3%."""
    x = _signal(1 << 17, seed=6) * 0.5
    kw = dict(snr_db=6.0, cfo=0.02)
    gen = torch.Generator().manual_seed(1)
    got = tch.channel_model(gen, torch.as_tensor(x), **kw) - tch.apply_cfo(
        torch.as_tensor(x), 0.02, 64)
    want = np.asarray(jch.channel_model(jax.random.PRNGKey(1), jnp.asarray(x),
                                        **kw)) - np.asarray(
        jch.apply_cfo(jnp.asarray(x), 0.02, 64))
    p_got = (got.abs() ** 2).mean().item()
    p_want = float(np.mean(np.abs(want) ** 2))
    target = float(np.mean(np.abs(x) ** 2)) / 10 ** 0.6
    assert abs(p_got / target - 1) < 0.03 and abs(p_want / target - 1) < 0.03
