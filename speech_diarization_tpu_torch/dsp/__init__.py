"""The DSP front end on the tensor's device: framing, preprocessing,
STFT / iSTFT, log-mel (kernel K2 and its plain version), resampling
(kernel K3 and scipy's host version), loudness and overlap-add.  Each
kernel is built at its first launch, never at import."""
from .framing import frame_signal, num_frames
from .loudness import integrated_loudness, loudness_normalize
from .mel import fbank_batch, log_mel_spectrogram, mel_filterbank
from .ola import ola_normalization, overlap_add
from .preprocess import preemphasis, preprocess_waveform, remove_dc
from .resample import resample_host, resample_poly
from .stft import hann_window, istft, sqrt_hann_window, stft

__all__ = [
    "frame_signal",
    "num_frames",
    "preemphasis",
    "remove_dc",
    "preprocess_waveform",
    "stft",
    "istft",
    "sqrt_hann_window",
    "hann_window",
    "mel_filterbank",
    "log_mel_spectrogram",
    "fbank_batch",
    "resample_poly",
    "resample_host",
    "integrated_loudness",
    "loudness_normalize",
    "overlap_add",
    "ola_normalization",
]
