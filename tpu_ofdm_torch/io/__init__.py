"""Host-side IO (counterpart of tpu_ofdm/io): sources/sinks, device feed,
PDU queues, UDP transports, with the JAX package's public names.

Importing this package touches no CUDA state: the feed makes its stream
and pinned buffers when it is constructed.
"""

from tpu_ofdm_torch.io.feed import DeviceFeed  # noqa: F401
from tpu_ofdm_torch.io import pmt  # noqa: F401
from tpu_ofdm_torch.io.pdu import Pdu, PduQueue, UdpPduLink, UdpSampleLink  # noqa: F401
from tpu_ofdm_torch.io.sources import (  # noqa: F401
    file_sink,
    file_size_samples,
    file_source,
    head,
    noise_source,
    sig_source,
    vector_source,
)
from tpu_ofdm_torch.io.transport import (  # noqa: F401
    SpectrumFrame,
    SpectrumPublisher,
    SpectrumSubscriber,
    pack_spectrum,
    unpack_spectrum,
)
