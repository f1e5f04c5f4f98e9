"""Static configuration, shared with the JAX package.

`tpu_ofdm/config.py` imports only numpy, so both packages use the very same
dataclasses: sync words, carrier maps, pilot values and frame geometry are
identical by construction.  Everything a spec holds is a numpy array or a
Python scalar; the port turns what it needs into tensors on the device of
the data (see each op's cached constants).
"""

from tpu_ofdm.config import (
    BITS_PER_SYMBOL,
    HEADER_BITS,
    HEADER_CRC_BITS,
    HEADER_LEN_BITS,
    HEADER_NUM_BITS,
    OfdmConfig,
    OfdmSpec,
    StreamConfig,
)

__all__ = [
    "BITS_PER_SYMBOL",
    "HEADER_BITS",
    "HEADER_CRC_BITS",
    "HEADER_LEN_BITS",
    "HEADER_NUM_BITS",
    "OfdmConfig",
    "OfdmSpec",
    "StreamConfig",
]
