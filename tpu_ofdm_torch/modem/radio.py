"""Full-duplex OFDM radio: TX and RX as one executor Block (counterpart of
tpu_ofdm/modem/radio.py, itself the counterpart of gr-ofdm_tools'
ofdm_radio_hier).

One step takes (TxStreamIn, a received block of block_size samples) and
returns RadioOut(tx=TxStreamOut, rx=RxStreamOut).  The carry is (tx carry,
rx carry); the two directions share nothing, as in the reference.
"""

from __future__ import annotations

from typing import NamedTuple

from tpu_ofdm_torch.config import OfdmSpec, StreamConfig
from tpu_ofdm_torch.modem import rx_stream, tx_stream
from tpu_ofdm_torch.modem.rx_stream import RxStreamOut, rx_stream_block
from tpu_ofdm_torch.modem.tx_stream import (TxStreamIn, TxStreamOut,
                                            tx_stream_block)
from tpu_ofdm_torch.stream.block import Block


class RadioOut(NamedTuple):
    tx: TxStreamOut   # samples to the air interface + accepted mask
    rx: RxStreamOut   # demodulated frame slots from the received block


def ofdm_radio(spec: OfdmSpec, stream_cfg: StreamConfig,
               equalizer: str = "pilot_phase", output: str = "hard",
               tx_gap: int | None = None) -> Block:
    """Full-duplex modem Block; `equalizer` and `output` go to the RX half
    (modem.rx.demod_frame), `tx_gap` to the TX half."""
    tx = tx_stream_block(spec, stream_cfg, gap=tx_gap)
    rx = rx_stream_block(spec, stream_cfg, equalizer=equalizer, output=output)

    def init(device):
        return (tx.init(device), rx.init(device))

    def apply(state, x):
        tx_in, rx_samples = x
        ts, rs = state
        ts, tout = tx.apply(ts, TxStreamIn(*tx_in))
        rs, rout = rx.apply(rs, rx_samples)
        return (ts, rs), RadioOut(tout, rout)

    return Block(init, apply, "ofdm_radio", latency=rx.latency,
                 stream_input=False)


def carry_from_jax(state, device):
    """The JAX radio's carry (tx carry, rx carry) -> this package's."""
    ts, rs = state
    return (tx_stream.carry_from_jax(ts, device),
            rx_stream.carry_from_jax(rs, device))


def carry_to_jax(state):
    """This package's radio carry -> the JAX radio's, as numpy arrays."""
    ts, rs = state
    return (tx_stream.carry_to_jax(ts), rx_stream.carry_to_jax(rs))
