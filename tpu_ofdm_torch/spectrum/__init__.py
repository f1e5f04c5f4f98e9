"""Spectrum tools: PSD probe, max/avg hold, waterfall, polyphase channelizer
(counterpart of tpu_ofdm/spectrum)."""

from tpu_ofdm_torch.spectrum.channelizer import (  # noqa: F401
    channelize,
    channelizer_block,
    lowpass_taps,
    polyphase_decompose,
)
from tpu_ofdm_torch.spectrum.probe import SpectrumSummary, spectrum_probe_block  # noqa: F401
from tpu_ofdm_torch.spectrum.psd import (  # noqa: F401
    iir_average,
    log_pwr_fft,
    log_pwr_fft_block,
    psd_frames,
)
from tpu_ofdm_torch.spectrum.waterfall import (  # noqa: F401
    render_ascii,
    render_spectrum_line,
    waterfall_block,
)
