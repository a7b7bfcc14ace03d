from .align import align_by_xcorr, crop_match  # noqa: F401
from .mel import mel_fbanks_htk, mel_mag  # noqa: F401
from .resample import resample, resample_kernel  # noqa: F401
from .stft import hann_window, stft_mag  # noqa: F401
