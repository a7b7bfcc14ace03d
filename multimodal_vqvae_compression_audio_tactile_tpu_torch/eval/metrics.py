"""Evaluation metrics: ST-SIM, both PSNR protocols, SNR/MAE subsets, SSIM.

Port of the JAX package's ``eval/metrics.py``, numpy on the host as there
(its mel magnitudes and resampling come from the port's ``dsp``, on the
CPU). The protocols are carried over exactly, since the baseline numbers
depend on them:

- **ST-SIM**: per-frame cosine similarity across 64 mel bins of
  max-normalised mel magnitude at 24 kHz, mapped to [0, 1] by 0.5 (cos + 1).
- **PSNR_raw (global peak)**: xcorr-align at the original tactile rate,
  then 10 log10(peak_global^2 / MSE) with one corpus-wide peak.
- **PSNR_3k_aligned**: align at 24 kHz, downsample both to 3 kHz, PSNR with
  peak 1.0. The two protocols differ by ~10 dB on identical models.
- **PLC subset metrics**: MAE / SNR / PSNR over masked and unmasked sample
  subsets through the token-to-sample mask projection, and SSIM on mel
  images (scikit-image's definition, written out).
"""

from __future__ import annotations

import math
from typing import List, Sequence, Tuple

import numpy as np

from ..dsp.align import align_by_xcorr, crop_match
from ..dsp.mel import mel_mag
from ..dsp.resample import resample
from ..utils.wav_io import load_wav_mono


# ----------------------------------------------------------------- ST-SIM

def _interp_frames_np(M: np.ndarray, T_out: int) -> np.ndarray:
    T_in = M.shape[-1]
    if T_in == T_out:
        return M
    pos = (np.arange(T_out) + 0.5) * (T_in / T_out) - 0.5
    pos = np.clip(pos, 0.0, T_in - 1.0)
    lo = np.floor(pos).astype(np.int64)
    hi = np.minimum(lo + 1, T_in - 1)
    w = pos - lo
    return M[..., lo] * (1.0 - w) + M[..., hi] * w


def stsim_batch(ref: np.ndarray, est: np.ndarray, sr: int = 24000) -> List[float]:
    """ref, est: [B, 1, T] (or [B, T]) at 24 kHz -> list of ST-SIM in [0, 1]."""
    r = ref[:, 0] if ref.ndim == 3 else ref
    e = est[:, 0] if est.ndim == 3 else est
    Mr = np.asarray(mel_mag(np.asarray(r), sr=sr))
    Me = np.asarray(mel_mag(np.asarray(e), sr=sr))
    Tf = max(Mr.shape[-1], Me.shape[-1])
    Mr = _interp_frames_np(Mr, Tf)
    Me = _interp_frames_np(Me, Tf)
    num = (Mr * Me).sum(axis=1)
    den = np.maximum(np.linalg.norm(Mr, axis=1) * np.linalg.norm(Me, axis=1), 1e-8)
    cos_t = np.clip(num / den, -1.0, 1.0)
    val = 0.5 * (cos_t.mean(axis=-1) + 1.0)
    return [float(v) for v in val]


# ----------------------------------------------------------------- PSNR protocols

def psnr_global_peak_db(ref: np.ndarray, est: np.ndarray, peak: float,
                        eps: float = 1e-12) -> float:
    r = np.asarray(ref, np.float32).reshape(-1)
    e = np.asarray(est, np.float32).reshape(-1)
    mse = float(np.mean((r - e) ** 2)) + eps
    peak = max(float(peak), eps)
    return 10.0 * math.log10(peak * peak / mse)


def compute_global_peak(wav_paths: Sequence[str]) -> float:
    """Max |amplitude| over all tactile WAVs (raw, unclamped)
    (reference: Evaluation/dac_vcpwq_proposed6_latency.py:216-226)."""
    max_val = 0.0
    for p in wav_paths:
        w, _ = load_wav_mono(p)
        max_val = max(max_val, float(np.abs(w).max()))
    return max_val if max_val > 0.0 else 1.0


def psnr_batch(ref: np.ndarray, est: np.ndarray, eps: float = 1e-12) -> List[float]:
    """PSNR with peak = 1.0 over [B, 1, T]."""
    r = np.asarray(ref, np.float32)
    e = np.asarray(est, np.float32)
    mse = np.maximum(((r - e) ** 2).mean(axis=(-2, -1)), eps)
    return [float(v) for v in 10.0 * np.log10(1.0 / mse)]


def psnr_3k_aligned_batch(ref_24: np.ndarray, est_24: np.ndarray,
                          eval_sr: int = 24000, orig_sr: int = 3000,
                          max_shift: int = 200) -> List[float]:
    """Align at 24 kHz, downsample both to 3 kHz, PSNR peak=1.0
    (reference: Evaluation/compare_dacvsproposal_5_eval.py:212-223)."""
    vals = []
    for b in range(ref_24.shape[0]):
        r = ref_24[b].reshape(-1)
        e = est_24[b].reshape(-1)
        r_a, e_a, _ = align_by_xcorr(r, e, max_shift)
        r3 = np.asarray(resample(np.asarray(r_a), eval_sr, orig_sr))
        e3 = np.asarray(resample(np.asarray(e_a), eval_sr, orig_sr))
        vals += psnr_batch(r3[None], e3[None])
    return vals


def align_and_psnr_raw(ref_orig: np.ndarray, est_orig: np.ndarray,
                       peak_global: float, max_shift: int = 200
                       ) -> Tuple[float, np.ndarray, np.ndarray]:
    """The raw-PSNR protocol inner step: crop, xcorr-align at the original SR,
    global-peak PSNR. Returns (psnr, ref_aligned, est_aligned)."""
    r_c, e_c = crop_match(ref_orig.reshape(1, -1), est_orig.reshape(1, -1))
    r_a, e_a, _ = align_by_xcorr(r_c, e_c, max_shift)
    r_a, e_a = crop_match(r_a, e_a)
    return psnr_global_peak_db(r_a, e_a, peak_global), r_a, e_a


# ----------------------------------------------------------------- PLC subsets

def mae_subset(ref: np.ndarray, est: np.ndarray, mask: np.ndarray) -> float:
    if mask.sum() == 0:
        return float("nan")
    return float(np.abs((ref - est))[mask].mean())


def snr_subset_db(ref: np.ndarray, est: np.ndarray, mask: np.ndarray,
                  eps: float = 1e-7) -> float:
    if mask.sum() == 0:
        return float("nan")
    r = ref[mask].astype(np.float32)
    e = est[mask].astype(np.float32)
    num = float(np.mean(r ** 2))
    den = float(np.mean((r - e) ** 2)) + eps
    return 10.0 * math.log10(num / den) if num > 0 else float("-inf")


def psnr_subset_db(ref: np.ndarray, est: np.ndarray, mask: np.ndarray,
                   peak: float, eps: float = 1e-7) -> float:
    if mask.sum() == 0:
        return float("nan")
    r = ref[mask].astype(np.float32)
    e = est[mask].astype(np.float32)
    mse = float(np.mean((r - e) ** 2)) + eps
    peak = max(float(peak), eps)
    return 10.0 * math.log10(peak * peak / mse)


def token_mask_to_sample_mask(latent_mask: np.ndarray, t_wave: int) -> np.ndarray:
    """Project a [T_lat] token mask onto [t_wave] samples
    (reference: PLC/PLC1_eval.py:652-656, samples_per_token mapping)."""
    t_lat = latent_mask.shape[-1]
    if t_lat == 0 or t_wave == 0:
        return np.zeros(t_wave, bool)
    samples_per_token = float(t_wave) / float(t_lat)
    token_idx = np.clip((np.arange(t_wave) / samples_per_token).astype(np.int64),
                        0, t_lat - 1)
    return latent_mask.astype(bool)[token_idx]


# ----------------------------------------------------------------- SSIM (mel)

def ssim(X: np.ndarray, Y: np.ndarray, data_range: float = 1.0,
         win_size: int = 7, K1: float = 0.01, K2: float = 0.03) -> float:
    """Structural similarity of two 2-D images, matching
    skimage.metrics.structural_similarity defaults (uniform 7x7 window,
    sample covariance, border crop). Reimplemented: scikit-image is unavailable
    (reference uses it at PLC/PLC1_eval.py:293-301)."""
    from scipy.ndimage import uniform_filter

    if X.shape != Y.shape:
        raise ValueError("ssim: shape mismatch")
    if min(X.shape) < win_size:
        win_size = min(X.shape) | 1  # keep odd, shrink to fit
        if win_size < 3:
            # fewer than 3 rows/cols leaves nothing after the border crop
            # (skimage raises here too); callers fall back to norm similarity
            raise ValueError("ssim: image smaller than minimum 3x3 window")
    X = X.astype(np.float64)
    Y = Y.astype(np.float64)
    NP = win_size ** 2
    cov_norm = NP / (NP - 1.0)
    f = lambda a: uniform_filter(a, size=win_size, mode="nearest")
    ux, uy = f(X), f(Y)
    uxx, uyy, uxy = f(X * X), f(Y * Y), f(X * Y)
    vx = cov_norm * (uxx - ux * ux)
    vy = cov_norm * (uyy - uy * uy)
    vxy = cov_norm * (uxy - ux * uy)
    C1 = (K1 * data_range) ** 2
    C2 = (K2 * data_range) ** 2
    S = ((2 * ux * uy + C1) * (2 * vxy + C2)) / (
        (ux * ux + uy * uy + C1) * (vx + vy + C2))
    pad = (win_size - 1) // 2
    return float(S[pad: S.shape[0] - pad, pad: S.shape[1] - pad].mean())


def _stsim_core(A: np.ndarray, B: np.ndarray) -> float:
    """SSIM with the reference's norm-similarity fallback
    (reference: PLC/PLC1_eval.py:293-301)."""
    try:
        return ssim(A, B, data_range=1.0)
    except ValueError:
        diff = float(np.linalg.norm(A - B))
        denom = float(np.linalg.norm(A)) + float(np.linalg.norm(B)) + 1e-12
        return max(0.0, 1.0 - diff / denom)


def stsim_mel_with_mask(ref: np.ndarray, est: np.ndarray,
                        latent_mask: np.ndarray, sr: int = 24000,
                        mel_hop: int = 128) -> Tuple[float, float, float]:
    """SSIM-based ST-SIM on mel magnitudes: (global, masked frames, unmasked frames)
    (reference: PLC/PLC1_eval.py:270-330)."""
    X = np.asarray(mel_mag(np.asarray(ref.reshape(1, -1)), sr=sr))[0]
    Y = np.asarray(mel_mag(np.asarray(est.reshape(1, -1)), sr=sr))[0]
    stsim_global = _stsim_core(X, Y)

    n_frames = X.shape[-1]
    t_wave = ref.reshape(-1).shape[0]
    t_lat = int(np.asarray(latent_mask).shape[-1])
    if t_lat == 0 or t_wave == 0 or n_frames == 0:
        return stsim_global, float("nan"), float("nan")

    samples_per_token = float(t_wave) / float(t_lat)
    frame_centers = np.arange(n_frames) * mel_hop
    token_idx = np.clip((frame_centers / samples_per_token).astype(np.int64),
                        0, t_lat - 1)
    frame_mask = np.asarray(latent_mask, bool)[token_idx]

    def subset(m):
        idx = np.where(m)[0]
        if idx.size == 0:
            return float("nan")
        return _stsim_core(X[:, idx], Y[:, idx])

    return stsim_global, subset(frame_mask), subset(~frame_mask)


def mean_ci95(vals: Sequence[float]) -> Tuple[float, float]:
    """mean and 1.96*sigma/sqrt(n) (reference CI convention,
    Evaluation/dac_vcpwq_proposed6_latency.py:596-597)."""
    arr = np.asarray([v for v in vals if np.isfinite(v)], np.float64)
    n = arr.size
    if n == 0:
        return float("nan"), float("nan")
    return float(arr.mean()), 1.96 * float(arr.std(ddof=0)) / max(1.0, math.sqrt(n))
