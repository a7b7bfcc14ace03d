"""The port's evaluation metrics against the JAX package's
(``tests/test_metrics.py``'s cases), on the CPU: the same numbers from the
same numpy inputs (PSNR protocols and subsets to 1e-4 dB, ST-SIM and SSIM
to 1e-5, the masks and CIs exactly), and the properties that file checks."""

import math

import numpy as np
import pytest

from multimodal_vqvae_compression_audio_tactile_tpu.eval import metrics as JM
from multimodal_vqvae_compression_audio_tactile_tpu_torch.eval import metrics as M
from multimodal_vqvae_compression_audio_tactile_tpu_torch.utils import wav_io


def _agree(got, ref, tol):
    return got == ref or (math.isnan(got) and math.isnan(ref)) or abs(got - ref) <= tol


def _same(fn, *args, tol=1e-4, **kw):
    got, ref = getattr(M, fn)(*args, **kw), getattr(JM, fn)(*args, **kw)
    if isinstance(ref, (list, tuple)):
        assert len(got) == len(ref)
        for g, r in zip(got, ref):
            assert _agree(g, r, tol), (fn, g, r)
    else:
        assert _agree(got, ref, tol), (fn, got, ref)
    return got


def test_psnr_protocols(rng):
    ref = np.zeros(1000, np.float32)
    est = np.full(1000, 0.1, np.float32)
    assert abs(_same("psnr_global_peak_db", ref, est, 2.0) - 26.0206) < 1e-3
    x = rng.standard_normal(500).astype(np.float32)
    assert _same("psnr_global_peak_db", x, x, 1.0) > 100
    vals = _same("psnr_batch", np.zeros((2, 1, 100), np.float32),
                 np.full((2, 1, 100), 0.5, np.float32))
    assert all(abs(v - 10 * math.log10(4.0)) < 1e-4 for v in vals)
    t = np.arange(24000) / 24000
    r = np.sin(2 * np.pi * 80 * t).astype(np.float32) * 2.0
    e = r + 0.05 * rng.standard_normal(24000).astype(np.float32)
    e = np.concatenate([np.zeros(17, np.float32), e])[:24000]
    raw, r_a, e_a = M.align_and_psnr_raw(r, e, peak_global=4.39)
    jraw, jr_a, je_a = JM.align_and_psnr_raw(r, e, peak_global=4.39)
    assert abs(raw - jraw) < 1e-4 and r_a.shape == jr_a.shape == e_a.shape
    p3k = _same("psnr_3k_aligned_batch", r[None, None], e[None, None])[0]
    assert raw != pytest.approx(p3k, abs=0.5)


def test_global_peak(tmp_path):
    paths = []
    for i, amp in enumerate([0.5, 3.7, 1.2]):
        p = str(tmp_path / f"t{i}.wav")
        wav_io.write_wav(p, np.full(100, amp, np.float32), 3000, subtype="FLOAT")
        paths.append(p)
    assert M.compute_global_peak(paths) == JM.compute_global_peak(paths)
    assert abs(M.compute_global_peak(paths) - 3.7) < 1e-5


@pytest.mark.parametrize("T", [12000, 24000, 9000])
def test_stsim_batch(rng, T):
    x = rng.standard_normal((2, 1, T)).astype(np.float32)
    assert all(abs(v - 1.0) < 1e-5 for v in _same("stsim_batch", x, x, tol=1e-5))
    t = np.arange(T) / 24000
    ref = np.sin(2 * np.pi * 200 * t).astype(np.float32)[None, None]
    close = ref + 0.01 * rng.standard_normal(ref.shape).astype(np.float32)
    far = rng.standard_normal(ref.shape).astype(np.float32)
    v_close = _same("stsim_batch", ref, close, tol=1e-5)[0]
    v_far = _same("stsim_batch", ref, far, tol=1e-5)[0]
    assert 0.0 <= v_far < v_close <= 1.0
    # different lengths: frames interpolated to the longer
    _same("stsim_batch", ref, far[..., : T - 3000], tol=1e-5)


def test_ssim(rng):
    X = rng.random((64, 100))
    assert abs(_same("ssim", X, X, tol=1e-12) - 1.0) < 1e-9
    Y = np.clip(X + 0.2 * rng.standard_normal(X.shape), 0, 1)
    v = _same("ssim", X, Y, data_range=1.0, tol=1e-12)
    Y2 = np.clip(X + 0.05 * rng.standard_normal(X.shape), 0, 1)
    assert 0.0 < v < _same("ssim", X, Y2, tol=1e-12) < 1.0
    assert np.isfinite(_same("ssim", rng.random((5, 5)), rng.random((5, 5)), tol=1e-12))
    with pytest.raises(ValueError):
        M.ssim(rng.random((1, 9)), rng.random((1, 9)))
    with pytest.raises(ValueError):
        M.ssim(rng.random((4, 9)), rng.random((4, 8)))


def test_subsets(rng):
    ref = rng.standard_normal(1000).astype(np.float32)
    est = ref.copy()
    mask = np.zeros(1000, bool)
    mask[:500] = True
    est[mask] += 0.5
    assert _same("mae_subset", ref, est, mask, tol=1e-7) == pytest.approx(0.5, abs=1e-5)
    assert _same("mae_subset", ref, est, ~mask, tol=1e-7) == pytest.approx(0.0, abs=1e-7)
    assert _same("psnr_subset_db", ref, est, ~mask, 1.0) > \
        _same("psnr_subset_db", ref, est, mask, 1.0)
    assert _same("snr_subset_db", ref, est, ~mask) > _same("snr_subset_db", ref, est, mask)
    x, m = np.zeros(10, np.float32), np.zeros(10, bool)
    for fn, args in (("mae_subset", ()), ("snr_subset_db", ()), ("psnr_subset_db", (1.0,))):
        assert math.isnan(_same(fn, x, x, m, *args))
    assert _same("snr_subset_db", x, x + 1, ~m) == float("-inf")


@pytest.mark.parametrize("t_lat,t_wave", [(4, 8), (75, 24000), (74, 23846), (0, 5), (3, 0)])
def test_token_to_sample_projection(t_lat, t_wave):
    lat = np.arange(t_lat) % 3 == 0
    got = M.token_mask_to_sample_mask(lat, t_wave)
    np.testing.assert_array_equal(got, JM.token_mask_to_sample_mask(lat, t_wave))
    if (t_lat, t_wave) == (4, 8):
        np.testing.assert_array_equal(got, [True, True, False, False, False, False, True, True])


@pytest.mark.parametrize("case", ["burst", "uniform", "none", "all", "short"])
def test_stsim_mel_with_mask(rng, case):
    T = 2000 if case == "short" else 24000
    t = np.arange(T) / 24000
    ref = np.sin(2 * np.pi * 150 * t).astype(np.float32)
    est = ref.copy()
    latent_mask = np.zeros(T // 320, bool)
    if case == "burst":
        latent_mask[20:40] = True
    elif case in ("uniform", "short"):
        latent_mask[::2] = True
    elif case == "all":
        latent_mask[:] = True
    sm = M.token_mask_to_sample_mask(latent_mask, T)
    est[sm] = rng.standard_normal(int(sm.sum())).astype(np.float32)
    g, masked, unmasked = _same("stsim_mel_with_mask", ref, est, latent_mask, tol=1e-5)
    assert np.isfinite(g)
    if case == "burst":
        assert unmasked > masked
    if case == "none":
        assert math.isnan(masked)


def test_mean_ci95():
    m, ci = M.mean_ci95([1.0, 2.0, 3.0, 4.0])
    assert (m, ci) == JM.mean_ci95([1.0, 2.0, 3.0, 4.0])
    assert m == 2.5 and ci == pytest.approx(1.96 * np.std([1, 2, 3, 4]) / 2, rel=1e-6)
    assert M.mean_ci95([1.0, float("nan"), 3.0])[0] == 2.0
    assert all(math.isnan(v) for v in M.mean_ci95([float("nan")]))
