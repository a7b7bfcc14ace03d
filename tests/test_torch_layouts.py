"""The port's layout options against the JAX package: ``time_major``,
``time_major_enc``, ``tail_kernel`` and ``poly_upsample``.

Same weights and numpy inputs through both, fp32 on the CPU (JAX at HIGHEST,
its Pallas kernels in interpret mode, the port's kernels through their plain
versions):

- the backbone's encode and decode under each combination of the flags that
  reach it, at 2e-5 of the output's scale (the JAX package's own tolerance
  in ``tests/test_resunit_tm_pallas.py``), on that file's reduced config;
- the geometry guards, which fall back to the channels-first forms as JAX's;
- ``StreamingCodec`` with explicit flags sends the same codes and bytes as
  the JAX package's, on tiny random weights and on the trained tiny weights
  of ``artifacts/evidence_tiny``, and its receiver's waveform agrees to 1e-4;
- the port resolves every flag left at ``None`` to off.
"""

import dataclasses
import itertools
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from multimodal_vqvae_compression_audio_tactile_tpu.core.config import CodecConfig as JCodecConfig
from multimodal_vqvae_compression_audio_tactile_tpu.core.config import DacConfig as JDacConfig
from multimodal_vqvae_compression_audio_tactile_tpu.eval.serving import StreamingCodec as JStreamingCodec
from multimodal_vqvae_compression_audio_tactile_tpu.models import allpred_ar as jar
from multimodal_vqvae_compression_audio_tactile_tpu.models import dac as jdac
from multimodal_vqvae_compression_audio_tactile_tpu_torch import convert
from multimodal_vqvae_compression_audio_tactile_tpu_torch.convert import load_codec, params_from_jax
from multimodal_vqvae_compression_audio_tactile_tpu_torch.core.config import CodecConfig, DacConfig
from multimodal_vqvae_compression_audio_tactile_tpu_torch.eval.serving import StreamingCodec
from multimodal_vqvae_compression_audio_tactile_tpu_torch.models import allpred_ar, dac
from multimodal_vqvae_compression_audio_tactile_tpu_torch.ops import resunit, resunit_tm

from test_torch_allpred_ar import EVIDENCE, _jax_trained

FLAGS = ("time_major", "time_major_enc", "tail_kernel", "poly_upsample")
# tests/test_resunit_tm_pallas.py:96-98: the reference strides, reduced widths
WIDTHS = dict(encoder_dim=4, decoder_dim=32, latent_dim=16, n_codebooks=2,
              codebook_size=16, codebook_dim=4)


def _close(got, ref, tol):
    got, ref = np.asarray(got, np.float32), np.asarray(ref, np.float32)
    assert got.shape == ref.shape
    assert float(np.max(np.abs(got - ref))) / (float(np.max(np.abs(ref))) + 1e-12) <= tol


def _pair(seed, up_k=None):
    """(JAX params, port DAC) with the same weights; ``up_k`` gives the first
    decoder block an up-conv of another kernel length than 2r."""
    jcfg = dataclasses.replace(JDacConfig(), **WIDTHS)
    jp = jax.tree.map(np.asarray, jdac.dac_init(jax.random.key(seed), jcfg))
    m = dac.DAC(dataclasses.replace(DacConfig(), **WIDTHS))
    if up_k is not None:
        w = jp["decoder"]["blocks"][0]["up"]["w"]
        c_out, c_in, _ = w.shape
        jp["decoder"]["blocks"][0]["up"]["w"] = (
            np.random.default_rng(seed).uniform(-0.1, 0.1, (c_out, c_in, up_k))
            .astype(np.float32))
        m.decoder.blocks[0].up = nn.ConvTranspose1d(c_in, c_out, up_k)
    convert._load(convert.dac_leaves(m), jp)
    return jax.tree.map(jnp.asarray, jp), jcfg, m


@pytest.fixture(scope="module")
def pair():
    return _pair(10)


def _flags(names, values):
    return dict(zip(names, values))


def _z(seed, t=6):
    return (0.3 * np.random.default_rng(seed).standard_normal((2, 16, t))).astype(np.float32)


def _wave(seed, n):
    return (0.3 * np.random.default_rng(seed).standard_normal((1, 1, n))).astype(np.float32)


@pytest.mark.parametrize("values", list(itertools.product((False, True), repeat=3)),
                         ids=lambda v: "-".join(str(int(b)) for b in v))
def test_decode_matches_jax_under_each_flag_combination(pair, values):
    jp, jcfg, m = pair
    flags = _flags(("time_major", "tail_kernel", "poly_upsample"), values)
    z = _z(11)
    ref = jdac.decode(jp, dataclasses.replace(jcfg, **flags), jnp.asarray(z))
    with torch.no_grad():
        got = m.decoder(torch.from_numpy(z), dataclasses.replace(m.decoder.cfg, **flags))
    _close(got, ref, 2e-5)


@pytest.mark.parametrize("values", list(itertools.product((False, True), repeat=2)),
                         ids=lambda v: "-".join(str(int(b)) for b in v))
def test_encode_matches_jax_under_each_flag_combination(pair, values):
    jp, jcfg, m = pair
    flags = _flags(("time_major_enc", "tail_kernel"), values)
    x = _wave(12, 2 * jcfg.hop)
    ref = jdac.encode(jp, dataclasses.replace(jcfg, **flags), jnp.asarray(x))
    with torch.no_grad():
        got = m.encoder(torch.from_numpy(x), dataclasses.replace(m.encoder.cfg, **flags))
    _close(got, ref, 2e-5)


def test_tail_kernel_sends_narrow_stacks_to_k3_only(pair, monkeypatch):
    """Under ``tail_kernel`` the stacks with C < 256 go to K3 and the wide
    ones stay where they were; here every stack is narrow."""
    _, _, m = pair
    calls = {"k1": 0, "k3": 0}

    def count(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped

    monkeypatch.setattr(dac, "resunit_stack", count("k1", resunit.resunit_stack))
    monkeypatch.setattr(dac, "resunit_stack_tm", count("k3", resunit_tm.resunit_stack_tm))
    z = torch.from_numpy(_z(13))
    with torch.no_grad():
        m.decoder(z, dataclasses.replace(m.decoder.cfg, tail_kernel=True))
        assert calls == {"k1": 0, "k3": 4}
        m.decoder(z, dataclasses.replace(m.decoder.cfg, time_major=True))
        assert calls == {"k1": 0, "k3": 4}      # time-major chain, no kernel
        m.decoder(z)
        assert calls == {"k1": 4, "k3": 4}


def test_encoder_guard_falls_back_for_a_length_off_the_hop(pair):
    """T not a multiple of the hop: the time-major encoder is not taken, in
    either package."""
    jp, jcfg, m = pair
    x = _wave(14, 2 * jcfg.hop + 40)
    flags = dict(time_major_enc=True)
    ref = jdac.encode(jp, dataclasses.replace(jcfg, **flags), jnp.asarray(x))
    with torch.no_grad():
        assert not m.encoder.time_major_ok(torch.from_numpy(x))
        got = m.encoder(torch.from_numpy(x), dataclasses.replace(m.encoder.cfg, **flags))
        nch = m.encoder(torch.from_numpy(x))
    assert torch.equal(got, nch)
    _close(got, ref, 2e-5)


def test_decoder_guards_fall_back_for_an_up_conv_off_2r():
    """An up-conv whose kernel is not 2r: the time-major decoder is refused
    (the channels-first decoder runs) and that block's polyphase form too (it
    upsamples in the dilated form), in either package."""
    jp, jcfg, m = _pair(15, up_k=19)
    assert not m.decoder.poly_geometry_ok()
    z = _z(16)
    flags = dict(time_major=True, poly_upsample=True)
    ref = jdac.decode(jp, dataclasses.replace(jcfg, **flags), jnp.asarray(z))
    with torch.no_grad():
        got = m.decoder(torch.from_numpy(z), dataclasses.replace(m.decoder.cfg, **flags))
        nch = m.decoder(torch.from_numpy(z),
                        dataclasses.replace(m.decoder.cfg, poly_upsample=True))
    assert torch.equal(got, nch)
    _close(got, ref, 2e-5)


SERVING_FLAGS = [
    dict(time_major=True, time_major_enc=True, tail_kernel=True, poly_upsample=True),
    dict(tail_kernel=True),
    dict(time_major=True, time_major_enc=True),
    dict(poly_upsample=True),
]


def _serving_pair(weights):
    if weights == "tiny":
        jcfg = JCodecConfig().tiny()
        jp = jar.codec_init(jax.random.key(0), jcfg)
        return jp, jcfg, params_from_jax(jax.tree.map(np.asarray, jp), CodecConfig().tiny())
    backbone = os.path.join(EVIDENCE, "backbone", "best.msgpack")
    head = os.path.join(EVIDENCE, "sweep", "rvqB4_K32", "best.msgpack")
    jcfg = JCodecConfig().tiny().with_rvq(4, 32)
    return (_jax_trained(backbone, head, jcfg), jcfg,
            load_codec(backbone, head, CodecConfig().tiny().with_rvq(4, 32)))


@pytest.fixture(scope="module", params=["tiny", "evidence_tiny"])
def serving_pair(request):
    return _serving_pair(request.param)


@pytest.mark.parametrize("flags", SERVING_FLAGS,
                         ids=lambda f: "+".join(sorted(f)))
def test_streaming_codec_sends_jax_codes_with_explicit_flags(serving_pair, flags):
    jp, jcfg, m = serving_pair
    rng = np.random.default_rng(17)
    a, tc = (0.1 * rng.standard_normal((2, 1, 1, 9600))).astype(np.float32)
    jsc = JStreamingCodec(jp, jcfg, batch=1, frame_sec=0.4, fast=False,
                          compute_dtype=jnp.float32, **flags)
    sc = StreamingCodec(m, batch=1, frame_sec=0.4, fast=False, compute_dtype=torch.float32,
                        device="cpu", **flags)
    assert all(getattr(sc.cfg.dac, k) == getattr(jsc.cfg.dac, k) for k in FLAGS)
    _, jcodes = jsc.encode(jnp.asarray(a), jnp.asarray(tc))
    _, codes = sc.encode(a, tc)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(jcodes))
    streams = sc.encode_to_bytes(a, tc)
    assert streams == jsc.encode_to_bytes(jnp.asarray(a), jnp.asarray(tc))
    _close(sc.decode_from_bytes(a, streams),
           jsc.decode_from_bytes(jnp.asarray(a), streams), 1e-4)


def test_none_resolves_every_flag_to_off():
    """The JAX package turns ``time_major`` and ``poly_upsample`` on below
    batch 8 when fast; the port leaves all four off until the card decides."""
    codec = allpred_ar.codec_init(CodecConfig().tiny(), torch.Generator().manual_seed(0))
    for fast in (True, False):
        sc = StreamingCodec(codec, batch=1, frame_sec=0.2, fast=fast, device="cpu",
                            compute_dtype=torch.bfloat16 if fast else torch.float32)
        assert not any(getattr(sc.cfg.dac, k) for k in FLAGS)
    sc = StreamingCodec(codec, batch=1, frame_sec=0.2, fast=False, device="cpu",
                        compute_dtype=torch.float32, time_major=True, poly_upsample=False)
    assert sc.cfg.dac.time_major and not sc.cfg.dac.poly_upsample
