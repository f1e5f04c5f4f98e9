"""Host-side IO (counterpart of tpu_ofdm/io): sample sources and sinks.

Only what is ported is exported; the device feed, PDU queues and
transports come in later slices.  Importing this package imports no feed.
"""

from tpu_ofdm_torch.io.sources import (  # noqa: F401
    file_sink,
    file_size_samples,
    file_source,
    head,
    noise_source,
    sig_source,
    vector_source,
)
