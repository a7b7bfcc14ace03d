"""The port's two-pass parallel AR roll against its scan and against the JAX
package's parallel roll, on the CPU.

Same weights (the JAX package's init, carried by ``convert.params_from_jax``)
and the same numpy inputs. ``ar_roll_parallel`` gives the scan's codes and
JAX's exactly and latents within 1e-5 (the anchors of the JAX package's
``tests/test_ar_parallel.py``), partial last chunks, a rate subset and the
``chunk = 1`` fallback included; ``encode_latents_parallel`` and
``decode_from_codes_parallel`` likewise end to end (waveforms within 1e-4).
``StreamingCodec(parallel_roll=True)`` transmits the scan wrapper's bytes,
and ``parallel_roll=None`` means the scan, as in the JAX package
(``tests/test_serving.py``).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from multimodal_vqvae_compression_audio_tactile_tpu.core.config import (
    CodecConfig as JCodecConfig, DacConfig as JDacConfig, PredictorConfig as JPredictorConfig,
    RVQConfig as JRVQConfig)
from multimodal_vqvae_compression_audio_tactile_tpu.models import allpred_ar as jar
from multimodal_vqvae_compression_audio_tactile_tpu.models import ar_parallel as jpar
from multimodal_vqvae_compression_audio_tactile_tpu_torch.convert import params_from_jax
from multimodal_vqvae_compression_audio_tactile_tpu_torch.core.config import (
    CodecConfig, DacConfig, PredictorConfig, RVQConfig)
from multimodal_vqvae_compression_audio_tactile_tpu_torch.eval.serving import StreamingCodec
from multimodal_vqvae_compression_audio_tactile_tpu_torch.models import allpred_ar, ar_parallel

from test_torch_plc import _one_torch_thread  # noqa: F401  (autouse, this module too)

LAT_TOL, WAVE_TOL = 1e-5, 1e-4


def _cfgs(chunk: int = 4):
    """The JAX test's tiny codec (8 heads, 3 books of 16 codes, 16-dim
    codes), in both packages."""
    jd, d = JDacConfig().tiny(), DacConfig().tiny()
    jcfg = JCodecConfig(dac=jd, predictor=JPredictorConfig(dim=jd.latent_dim, heads=8),
                        rvq=JRVQConfig(code_dim=16, n_books=3, n_embed=16), ar_chunk_tok=chunk)
    cfg = CodecConfig(dac=d, predictor=PredictorConfig(dim=d.latent_dim, heads=8),
                      rvq=RVQConfig(code_dim=16, n_books=3, n_embed=16), ar_chunk_tok=chunk)
    return jcfg, cfg


def _pair(seed: int, chunk: int = 4):
    jcfg, cfg = _cfgs(chunk)
    jp = jar.codec_init(jax.random.key(seed), jcfg)
    return jp, jcfg, params_from_jax(jax.tree.map(np.asarray, jp), cfg)


@pytest.fixture(scope="module")
def codec():
    return _pair(0)


def _latents(T_lat: int, seed: int = 7, batch: int = 2):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((2, batch, 64, T_lat))).astype(np.float32)


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    assert float(np.max(np.abs(got - ref))) / (float(np.max(np.abs(ref))) + 1e-12) <= tol


def _check_roll(m, jp, jcfg, T_lat, seed, n_books_use=None):
    qa, zt = _latents(T_lat, seed)
    with torch.no_grad():
        scan = allpred_ar.ar_roll(m.head, m.cfg, torch.from_numpy(qa), torch.from_numpy(zt),
                                  n_books_use=n_books_use)
        par = ar_parallel.ar_roll_parallel(m.head, m.cfg, torch.from_numpy(qa),
                                           torch.from_numpy(zt), n_books_use=n_books_use)
    ref = jpar.ar_roll_parallel(jp.head, jcfg, jnp.asarray(qa), jnp.asarray(zt),
                                n_books_use=n_books_use)
    np.testing.assert_array_equal(par.codes.numpy(), scan.codes.numpy())
    np.testing.assert_array_equal(par.codes.numpy(), np.asarray(ref.codes))
    _close(par.z_run, scan.z_run, LAT_TOL)
    _close(par.z_run, ref.z_run, LAT_TOL)
    return par


@pytest.mark.parametrize("T_lat", [4, 10, 12, 17])
def test_roll_matches_scan_and_jax(codec, T_lat):
    jp, jcfg, m = codec
    par = _check_roll(m, jp, jcfg, T_lat, 7)
    assert par.codes.shape == (2, T_lat, 3) and par.codes.dtype == torch.int32


def test_roll_rate_subset(codec):
    jp, jcfg, m = codec
    par = _check_roll(m, jp, jcfg, 10, 3, n_books_use=2)
    assert par.codes.shape[-1] == 2


def test_chunk1_falls_back_to_scan():
    jp, jcfg, m = _pair(1, chunk=1)
    _check_roll(m, jp, jcfg, 5, 0)


def test_last_row_independent_of_carry(codec):
    """The premise of the two passes: a chunk's row chunk-1 does not move with
    the carry in query row 0."""
    _, _, m = codec
    qa, _ = _latents(4, 5)

    def last_row(carry):
        zt_prev = torch.zeros(2, 64, 4)
        zt_prev[..., 0] = carry
        with torch.no_grad():
            return m.head.predict(zt_prev, torch.from_numpy(qa))[..., -1]

    assert torch.equal(last_row(0.0), last_row(123.0))


def _signals(seed):
    rng = np.random.default_rng(seed)
    return (0.5 * rng.standard_normal((2, 2, 1, 3200))).astype(np.float32)


def test_encode_latents_parallel(codec):
    jp, jcfg, m = codec
    a, tc = _signals(11)
    z_par, c_par = ar_parallel.encode_latents_parallel(m, torch.from_numpy(a),
                                                       torch.from_numpy(tc))
    z_scan, c_scan = allpred_ar.encode_latents(m, torch.from_numpy(a), torch.from_numpy(tc))
    z_ref, c_ref = jpar.encode_latents_parallel(jp, jcfg, jnp.asarray(a), jnp.asarray(tc))
    np.testing.assert_array_equal(c_par.numpy(), c_scan.numpy())
    np.testing.assert_array_equal(c_par.numpy(), np.asarray(c_ref))
    _close(z_par, z_scan, LAT_TOL)
    _close(z_par, z_ref, LAT_TOL)


def test_decode_from_codes_parallel(codec):
    jp, jcfg, m = codec
    a, tc = _signals(13)
    _, codes = allpred_ar.encode_latents(m, torch.from_numpy(a), torch.from_numpy(tc))
    w_par = ar_parallel.decode_from_codes_parallel(m, torch.from_numpy(a), codes)
    w_scan = allpred_ar.decode_from_codes(m, torch.from_numpy(a), codes)
    w_ref = jpar.decode_from_codes_parallel(jp, jcfg, jnp.asarray(a), jnp.asarray(codes.numpy()))
    _close(w_par, w_scan, WAVE_TOL)
    _close(w_par, w_ref, WAVE_TOL)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
def test_streaming_codec_parallel_roll_matches_scan(codec, dtype):
    _, _, m = codec
    a, tc = _signals(7)
    kw = dict(batch=2, frame_sec=3200 / 24000, compute_dtype=dtype, fast=False, device="cpu")
    sc = StreamingCodec(m, **kw)
    scp = StreamingCodec(m, parallel_roll=True, **kw)
    assert scp.parallel_roll and not sc.parallel_roll
    z, codes = sc.encode(a, tc)
    zp, codesp = scp.encode(a, tc)
    np.testing.assert_array_equal(codesp.numpy(), codes.numpy())
    _close(zp.float(), z.float(), LAT_TOL if dtype == torch.float32 else 1e-2)
    streams = scp.encode_to_bytes(a, tc)
    assert streams == sc.encode_to_bytes(a, tc)
    _close(scp.decode_from_bytes(a, streams), sc.decode_from_bytes(a, streams),
           WAVE_TOL if dtype == torch.float32 else 1e-2)


@pytest.mark.parametrize("batch", [2, 8])
def test_parallel_roll_none_means_scan(codec, batch):
    """The JAX package's policy (``eval/serving.py:85-86``): off at every batch
    unless asked for."""
    _, _, m = codec
    sc = StreamingCodec(m, batch=batch, frame_sec=3200 / 24000, device="cpu")
    assert sc.parallel_roll is False


def test_device_time_ms_schema(codec):
    """``device_time_ms`` keeps the JAX method's keys (on the CPU the chains
    are timed by the host clock)."""
    _, _, m = codec
    for roll in (False, True):
        out = StreamingCodec(m, batch=1, frame_sec=3200 / 24000, device="cpu",
                             parallel_roll=roll).device_time_ms(n_lo=1, n_hi=2, reps=1)
        assert set(out) == {"encode", "decode", "encode_frames_per_sec",
                            "decode_frames_per_sec", "encode_ms_per_batch",
                            "decode_ms_per_batch"}
        for k in ("encode", "decode"):
            assert set(out[k]) == {"ms_per_call", "slope_ms", "slope_reps_ms",
                                   "slope_spread_ms", "intercept_ms", "n_lo", "n_hi"}
            assert out[f"{k}_ms_per_batch"] == out[k]["ms_per_call"]
