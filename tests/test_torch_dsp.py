"""The port's DSP against the JAX package's (``tests/test_dsp.py``'s cases), on
the CPU: STFT magnitudes against JAX's and ``torch.stft``, the Hann window,
the HTK filterbank (bit-equal), mel magnitudes, resampling (3000 <-> 24000,
44100 -> 24000, the length contract, a tone kept, a tone above the new
Nyquist removed), xcorr alignment against JAX's and the brute-force loop
(exact ties: the first maximal shift wins; ties that the FFT's rounding
breaks go the JAX package's way), WAV IO and the pair split."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_vqvae_compression_audio_tactile_tpu import dsp as jdsp
from multimodal_vqvae_compression_audio_tactile_tpu.data import pairs as jpairs
from multimodal_vqvae_compression_audio_tactile_tpu.utils import wav_io as jwav_io
from multimodal_vqvae_compression_audio_tactile_tpu_torch import dsp
from multimodal_vqvae_compression_audio_tactile_tpu_torch.data import pairs
from multimodal_vqvae_compression_audio_tactile_tpu_torch.dsp import stft
from multimodal_vqvae_compression_audio_tactile_tpu_torch.utils import wav_io


@pytest.mark.parametrize("n_fft,hop,win", [(256, 64, None), (512, 128, None),
                                           (1024, 256, None), (512, 128, 256),
                                           (512, 128, 301)])
@pytest.mark.parametrize("T", [4000, 24000, 2001])
def test_stft_mag_matches_jax_and_torch(rng, n_fft, hop, win, T):
    x = rng.standard_normal((2, T)).astype(np.float32)
    got = dsp.stft_mag(torch.from_numpy(x), n_fft=n_fft, hop=hop, win_length=win)
    ref = np.asarray(jdsp.stft_mag(jnp.asarray(x), n_fft=n_fft, hop=hop, win_length=win))
    assert got.shape == ref.shape == (2, n_fft // 2 + 1, 1 + T // hop)
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)
    w = n_fft if win is None else win
    lib = torch.stft(torch.from_numpy(x), n_fft=n_fft, hop_length=hop, win_length=w,
                     window=torch.hann_window(w), center=True, pad_mode="reflect",
                     return_complex=True).abs()
    np.testing.assert_allclose(got.numpy(), lib.numpy(), rtol=1e-4, atol=1e-4)


def test_stft_zeroes_non_finite_and_clamps(rng):
    x = rng.standard_normal((1, 3000)).astype(np.float32)
    x[0, [5, 700, 1500]] = [np.nan, np.inf, -np.inf]
    got = dsp.stft_mag(torch.from_numpy(x), 512, 128, eps=1e-3)
    ref = np.asarray(jdsp.stft_mag(jnp.asarray(x), 512, 128, eps=1e-3))
    assert bool(torch.isfinite(got).all()) and float(got.min()) >= 1e-3
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-4)
    c = stft.stft_complex(torch.from_numpy(x), 512, 128)
    assert c.dtype == torch.complex64


def test_hann_window_periodic():
    np.testing.assert_allclose(dsp.hann_window(512).numpy(), torch.hann_window(512).numpy(),
                               atol=1e-6)
    np.testing.assert_array_equal(dsp.hann_window(400).numpy(),
                                  np.asarray(jdsp.hann_window(400)))


def test_mel_fbanks_bit_equal():
    for args in ((257, 0.0, 12000.0, 64, 24000), (513, 0.0, 8000.0, 40, 16000)):
        np.testing.assert_array_equal(dsp.mel_fbanks_htk(*args), jdsp.mel_fbanks_htk(*args))


@pytest.mark.parametrize("log", [False, True])
def test_mel_mag_matches_jax(rng, log):
    x = rng.standard_normal((2, 6000)).astype(np.float32)
    got = dsp.mel_mag(x, log=log)                   # numpy in: on the CPU
    ref = np.asarray(jdsp.mel_mag(x, log=log))
    assert isinstance(got, torch.Tensor) and got.device.type == "cpu"
    assert got.shape == ref.shape and got.shape[1] == 64
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-4, atol=1e-5 if not log else 1e-3)
    if not log:
        np.testing.assert_allclose(got.amax(dim=(1, 2)).numpy(), 1.0, atol=1e-6)


@pytest.mark.parametrize("sr_in,sr_out", [(3000, 24000), (24000, 3000), (44100, 24000),
                                          (24000, 24000)])
def test_resample_matches_jax(rng, sr_in, sr_out):
    x = rng.standard_normal((2, sr_in)).astype(np.float32)       # 1 s
    got = dsp.resample(x, sr_in, sr_out)
    ref = np.asarray(jdsp.resample(x, sr_in, sr_out))
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert got.shape[-1] == math.ceil(sr_out * sr_in / sr_in)
    np.testing.assert_allclose(got.numpy(), ref, rtol=0, atol=2e-5)
    kernels, width, og, ng = dsp.resample_kernel(sr_in, sr_out)
    jk, jw, jog, jng = jdsp.resample_kernel(sr_in, sr_out)
    np.testing.assert_array_equal(kernels, jk)
    assert (width, og, ng) == (jw, jog, jng)


@pytest.mark.parametrize("shape", [(1000,), (3, 1000), (2, 1, 777)])
def test_resample_shapes_and_identity(rng, shape):
    x = rng.standard_normal(shape).astype(np.float32)
    got = dsp.resample(x, 3000, 24000)
    assert got.shape == (*shape[:-1], 8 * shape[-1])
    np.testing.assert_allclose(got.numpy(), np.asarray(jdsp.resample(x, 3000, 24000)),
                               rtol=0, atol=2e-5)
    t = torch.from_numpy(x)
    same = dsp.resample(t, 24000, 24000)
    assert torch.equal(same, t) and same is not t


def test_resample_sine_preserved_and_alias_removed():
    sr_in, sr_out, f0 = 3000, 24000, 100.0
    x = np.sin(2 * np.pi * f0 * np.arange(sr_in) / sr_in).astype(np.float32)
    y = dsp.resample(x[None], sr_in, sr_out)[0].numpy()
    ref = np.sin(2 * np.pi * f0 * np.arange(y.size) / sr_out)
    assert np.abs(y[200:-200] - ref[200:-200]).max() < 5e-3
    t = np.arange(24000) / 24000
    hi = np.sin(2 * np.pi * 5000.0 * t).astype(np.float32)
    assert np.abs(dsp.resample(hi[None], 24000, 3000)[0].numpy()[100:-100]).max() < 0.05


def _brute_force(r, e, max_shift):
    best_s, best_c = 0, -1e18
    for s in range(-max_shift, max_shift + 1):
        if s < 0:
            r_seg, e_seg = r[-s:], e[: r.size + s]
        elif s > 0:
            r_seg, e_seg = r[:-s], e[s: s + r.size - s]
        else:
            r_seg, e_seg = r, e[: r.size]
        c = float(np.sum(r_seg.astype(np.float64) * e_seg.astype(np.float64)))
        if c > best_c:
            best_c, best_s = c, s
    return best_s


def test_align_matches_jax_and_brute_force(rng):
    for _ in range(5):
        r = rng.standard_normal(3000).astype(np.float32)
        e = np.roll(r, int(rng.integers(-150, 150))) \
            + 0.01 * rng.standard_normal(3000).astype(np.float32)
        ra, ea, s = dsp.align_by_xcorr(r, e, 200)
        jra, jea, js = jdsp.align_by_xcorr(r, e, 200)
        assert s == js == _brute_force(r, e, 200)
        np.testing.assert_array_equal(ra, jra)
        np.testing.assert_array_equal(ea, jea)


def _two_peaks(n, lo, hi):
    """ref a unit impulse at n // 2, est two equal peaks: scores tied at
    shifts -lo and +hi."""
    r = np.zeros(n, np.float32)
    r[n // 2] = 1.0
    e = np.zeros(n, np.float32)
    e[[n // 2 - lo, n // 2 + hi]] = 2.0
    return r, e


@pytest.mark.parametrize("n,lo,hi", [(4096, 10, 10), (4096, 40, 40), (300, 10, 10),
                                     (1000, 20, 20)])
def test_align_tie_takes_the_first_shift(n, lo, hi):
    """Two equal peaks whose FFT scores come out exactly equal: the first
    maximum in -max..+max wins, as in the brute-force loop."""
    r, e = _two_peaks(n, lo, hi)
    _, _, s = dsp.align_by_xcorr(r, e, 50)
    assert s == jdsp.align_by_xcorr(r, e, 50)[2] == _brute_force(r, e, 50) == -lo
    r2, e2 = dsp.crop_match(r[None], e[None, :200])
    assert r2.shape == e2.shape == (1, 200)


@pytest.mark.parametrize("n,lo,hi", [(256, 10, 10), (256, 5, 5), (1000, 40, 40)])
def test_align_rounded_tie_follows_jax(n, lo, hi):
    """Where the FFT's rounding leaves the earlier of two tied scores a unit
    in the last place lower (2 - 2**-52 against 2), the JAX package's
    alignment takes the later shift, unlike the brute-force loop; the port's
    copy takes the same shift as the JAX package."""
    r, e = _two_peaks(n, lo, hi)
    s = dsp.align_by_xcorr(r, e, 50)[2]
    assert s == jdsp.align_by_xcorr(r, e, 50)[2] == hi
    assert _brute_force(r, e, 50) == -lo


def test_wav_io_round_trips_as_jax(tmp_path, rng):
    x = (rng.standard_normal(5000) * 0.3).astype(np.float32)
    for sub in ("PCM_16", "FLOAT"):
        p, jp = str(tmp_path / f"a_{sub}.wav"), str(tmp_path / f"j_{sub}.wav")
        wav_io.write_wav(p, x, 3000, subtype=sub)
        jwav_io.write_wav(jp, x, 3000, subtype=sub)
        with open(p, "rb") as f, open(jp, "rb") as g:
            assert f.read() == g.read()
        y, sr = wav_io.load_wav_mono(p)
        jy, jsr = jwav_io.load_wav_mono(p)
        assert sr == jsr == 3000
        np.testing.assert_array_equal(y, jy)


def test_pairs_split_as_jax(tmp_path):
    for d in ("a", "t"):
        (tmp_path / d).mkdir()
        for i in range(11):
            (tmp_path / d / f"s{i:02d}.wav").write_bytes(b"")
    (tmp_path / "a" / "only_audio.wav").write_bytes(b"")
    got = pairs.pair_stems(str(tmp_path / "a"), str(tmp_path / "t"))
    assert got == jpairs.pair_stems(str(tmp_path / "a"), str(tmp_path / "t"))
    assert len(got) == 11
    for seed in (0, 7):
        assert pairs.split_items(got, 0.2, 300, seed) == jpairs.split_items(got, 0.2, 300, seed)
