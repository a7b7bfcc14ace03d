"""The port's training data path against the JAX package's, on the CPU.

Bit-equal: the int16 wire format, the synthetic corpus (the same seed
writes the same WAV bytes), the segment crops and the loader's batches,
order and threads included, on 24-kHz pairs (no resampling). On the
synthetic corpus (44.1-kHz audio, 3-kHz tactile) both resample to 24 kHz,
each package with its own resampler, whose outputs agree to 2e-5
(``tests/test_torch_dsp.py``): there the segments and batches are held to
that, and their crop positions and order are still exact.
"""

import numpy as np
import pytest
import torch

from multimodal_vqvae_compression_audio_tactile_tpu.data import loader as jloader
from multimodal_vqvae_compression_audio_tactile_tpu.data import segments as jseg
from multimodal_vqvae_compression_audio_tactile_tpu.data import synth as jsynth
from multimodal_vqvae_compression_audio_tactile_tpu.data import wire as jwire
from multimodal_vqvae_compression_audio_tactile_tpu_torch.data import loader, segments, synth, wire
from multimodal_vqvae_compression_audio_tactile_tpu_torch.utils.wav_io import write_wav


def test_wire_round_trip_matches_jax():
    rng = np.random.default_rng(0)
    x = np.clip(rng.standard_normal((3, 1, 500)), -1.2, 1.2).astype(np.float32)
    w = wire.encode_wave_i16(x)
    np.testing.assert_array_equal(w, jwire.encode_wave_i16(x))
    got = wire.decode_wave(torch.from_numpy(w))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(jwire.decode_wave(w)))
    f = torch.from_numpy(x)
    assert wire.decode_wave(f) is f


@pytest.mark.parametrize("kw", [dict(), dict(decorrelate=0.5, jitter_ms=2.0)])
def test_synth_corpus_bytes_match_jax(tmp_path, kw):
    pp = synth.make_synth_corpus(str(tmp_path / "p"), n_pairs=3, dur_sec=0.5, seed=11, **kw)
    jp = jsynth.make_synth_corpus(str(tmp_path / "j"), n_pairs=3, dur_sec=0.5, seed=11, **kw)
    assert [p[2] for p in pp] == [p[2] for p in jp]
    for a, b in zip(pp, jp):
        for i in range(2):
            with open(a[i], "rb") as fa, open(b[i], "rb") as fb:
                assert fa.read() == fb.read()


def test_synth_pair_matches_jax():
    a, t = synth.synth_pair(np.random.default_rng(3), dur_sec=0.3, material=4)
    ja, jt = jsynth.synth_pair(np.random.default_rng(3), dur_sec=0.3, material=4)
    np.testing.assert_array_equal(a, ja)
    np.testing.assert_array_equal(t, jt)


@pytest.mark.parametrize("need", [0, 1, 5, 40, 1000])
def test_reflect_pad_and_sanitize_match_jax(need):
    x = np.random.default_rng(need).standard_normal((1, 7)).astype(np.float32)
    x[0, 2] = np.nan
    x[0, 3] = np.inf
    np.testing.assert_array_equal(segments.sanitize_wave_np(x), jseg.sanitize_wave_np(x))
    np.testing.assert_array_equal(segments.reflect_pad_right(x, need),
                                  jseg.reflect_pad_right(x, need))
    one = x[:, :1]
    np.testing.assert_array_equal(segments.reflect_pad_right(one, need),
                                  jseg.reflect_pad_right(one, need))


@pytest.fixture(scope="module")
def pairs_24k(tmp_path_factory):
    """Pairs at 24 kHz of several lengths: longer than the segment (cropped),
    shorter (reflect-padded), unequal audio/tactile lengths."""
    root = tmp_path_factory.mktemp("p24")
    rng = np.random.default_rng(5)
    out = []
    for i, (la, lt) in enumerate([(9000, 9000), (7000, 8000), (3000, 3000), (12000, 11000),
                                  (4800, 4800), (100, 90), (6000, 6000)]):
        ap, tp = str(root / f"a{i}.wav"), str(root / f"t{i}.wav")
        write_wav(ap, np.clip(0.3 * rng.standard_normal(la), -1, 1), 24000, subtype="PCM_16")
        write_wav(tp, (0.5 * rng.standard_normal(lt)).astype(np.float32), 24000, subtype="FLOAT")
        out.append((ap, tp, f"p{i}"))
    return out


@pytest.mark.parametrize("epoch", [0, 3])
def test_segments_bit_equal_at_24k(pairs_24k, epoch):
    ds = segments.SegmentDataset(pairs_24k, sr=24000, seg=4800, seed=9)
    jds = jseg.SegmentDataset(pairs_24k, sr=24000, seg=4800, seed=9)
    ds.set_epoch(epoch)
    jds.set_epoch(epoch)
    for i in range(len(ds)):
        for got, ref in zip(ds[i], jds[i]):
            assert got.shape == (4800,) and got.dtype == ref.dtype
            np.testing.assert_array_equal(got, ref)


@pytest.mark.parametrize("shuffle,drop_last", [(True, True), (False, False)])
def test_loader_batches_bit_equal_at_24k(pairs_24k, shuffle, drop_last):
    ds = segments.SegmentDataset(pairs_24k, sr=24000, seg=4800, seed=9)
    jds = jseg.SegmentDataset(pairs_24k, sr=24000, seg=4800, seed=9)
    got = list(loader.batch_iterator(ds, 3, shuffle=shuffle, drop_last=drop_last, seed=9,
                                     epoch=2, num_threads=3))
    ref = list(jloader.batch_iterator(jds, 3, shuffle=shuffle, drop_last=drop_last, seed=9,
                                      epoch=2, num_threads=3))
    assert len(got) == len(ref) == (2 if drop_last else 3)
    for (a, t), (ja, jt) in zip(got, ref):
        assert a.dtype == np.float32 and a.shape[1] == 1
        np.testing.assert_array_equal(a, ja)
        np.testing.assert_array_equal(t, jt)


def test_loader_raises_a_worker_error():
    class Bad:
        def __len__(self):
            return 4

        def __getitem__(self, i):
            raise OSError("unreadable")
    with pytest.raises(OSError, match="unreadable"):
        list(loader.batch_iterator(Bad(), 2))


def test_synth_corpus_segments_and_batches_match_jax(tmp_path):
    pairs = synth.make_synth_corpus(str(tmp_path), n_pairs=5, dur_sec=0.5, seed=2)
    ds = segments.SegmentDataset(pairs, sr=24000, seg=4800, seed=4)
    jds = jseg.SegmentDataset(pairs, sr=24000, seg=4800, seed=4)
    for i in range(len(ds)):
        for got, ref in zip(ds[i], jds[i]):
            np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)
    got = list(loader.batch_iterator(ds, 2, seed=4, epoch=1))
    ref = list(jloader.batch_iterator(jds, 2, seed=4, epoch=1))
    assert len(got) == len(ref) == 2
    for (a, t), (ja, jt) in zip(got, ref):
        np.testing.assert_allclose(a, ja, rtol=0, atol=2e-5)
        np.testing.assert_allclose(t, jt, rtol=0, atol=2e-5)
