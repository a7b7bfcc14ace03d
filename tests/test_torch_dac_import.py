"""The port's descript-DAC weight import against the JAX package's.

The JAX package's torch twin of the descript-audio-codec architecture
(``tests/test_dac_import.py::build_torch_dac_twin``: weight-normalised
convolutions, Snake activations, descript's module names and padding) at
the tiny configuration is the checkpoint, as in that package's own tests
(no published weights are in the repository):

- the port's imported leaves equal the JAX package's import bit for bit;
- the imported backbone's latents, quantized latents and decode match the
  twin's within ``tests/test_dac_import.py``'s tolerances (rtol 1e-3, atol
  2e-4), its codes bit-exact, also at a cut depth (2 books);
- a ``.pth`` file, bare or descript's ``{"state_dict", "metadata"}``, loads
  with ``weights_only=True``;
- a synthetic state dict of plain (not weight-normalised) weights maps onto
  the backbone and runs through its forward (``TestMapperStructure``).
"""

import jax
import numpy as np
import pytest
import torch

from multimodal_vqvae_compression_audio_tactile_tpu.core.config import DacConfig as JDacConfig
from multimodal_vqvae_compression_audio_tactile_tpu.models import dac_import as jimport
from multimodal_vqvae_compression_audio_tactile_tpu_torch import convert
from multimodal_vqvae_compression_audio_tactile_tpu_torch.core.config import DacConfig
from multimodal_vqvae_compression_audio_tactile_tpu_torch.models import dac, dac_import

from test_dac_import import build_torch_dac_twin

CFG, JCFG = DacConfig().tiny(), JDacConfig().tiny()
TOL = dict(rtol=1e-3, atol=2e-4)


@pytest.fixture(scope="module", params=[3, 4])
def twin(request):
    return build_torch_dac_twin(JCFG, seed=request.param)


def test_weight_norm_fusion_matches_torch():
    conv = torch.nn.utils.weight_norm(torch.nn.Conv1d(4, 8, 7))
    sd = {f"c.{k}": v.detach().numpy() for k, v in conv.state_dict().items()}
    conv(torch.zeros(1, 4, 20))               # materialises the fused weight
    np.testing.assert_allclose(dac_import._fuse_weight_norm(sd, "c"),
                               conv.weight.detach().numpy(), rtol=1e-5, atol=1e-6)


def test_imported_leaves_equal_jax_import_bit_for_bit(twin):
    sd = twin.state_dict()
    want = jimport.import_torch_dac_state_dict(sd, JCFG)
    tree = dac_import.import_tree(sd, CFG)
    m = dac_import.import_torch_dac_state_dict(sd, CFG)
    got = convert.dac_tree(m)
    flat_want, tdef = jax.tree.flatten(want)
    for part in (tree, got):
        flat, pdef = jax.tree.flatten(jax.tree.map(np.asarray, part))
        assert pdef == tdef
        for a, b in zip(flat, flat_want):
            assert a.dtype == b.dtype == np.float32 and np.array_equal(a, b)


def _twin_forward(twin, x, n=None):
    with torch.no_grad():
        z = twin.encoder(torch.from_numpy(x))
        zq, codes = twin.quantizer(z, n_quantizers=n)
        return z, zq, codes, twin.decoder(zq)


def test_forward_and_codes_match_the_twin(twin):
    x = (0.3 * np.random.default_rng(0).standard_normal((2, 1, 3200))).astype(np.float32)
    z_t, zq_t, codes_t, y_t = _twin_forward(twin, x)
    m = dac_import.import_torch_dac_state_dict(twin.state_dict(), CFG)
    xt = torch.from_numpy(x)
    z = dac.encode(m, CFG, xt)
    np.testing.assert_allclose(z.numpy(), z_t.numpy(), **TOL)
    zq, codes = dac.encode_quantized(m, CFG, xt)
    np.testing.assert_array_equal(codes.numpy(), codes_t.numpy())       # bit-exact
    np.testing.assert_allclose(zq.numpy(), zq_t.numpy(), **TOL)
    np.testing.assert_allclose(dac.decode(m, CFG, zq).numpy(), y_t.numpy(), **TOL)


def test_rate_scalable_depth_matches_the_twin(twin):
    x = (0.3 * np.random.default_rng(1).standard_normal((1, 1, 3200))).astype(np.float32)
    _, _, codes_t, _ = _twin_forward(twin, x, n=2)
    m = dac_import.import_torch_dac_state_dict(twin.state_dict(), CFG)
    _, codes = dac.encode_quantized(m, CFG, torch.from_numpy(x), n_quantizers=2)
    np.testing.assert_array_equal(codes.numpy(), codes_t.numpy())


@pytest.mark.parametrize("wrapped", [False, True])
def test_load_torch_dac_reads_a_pth_with_weights_only(twin, tmp_path, wrapped):
    sd = twin.state_dict()
    blob = {"state_dict": sd, "metadata": {"kwargs": {"sample_rate": 24000}}} if wrapped else sd
    path = tmp_path / "dac.pth"
    torch.save(blob, path)
    m = dac_import.load_torch_dac(str(path), CFG)
    ref = dac_import.import_torch_dac_state_dict(sd, CFG)
    for (k, a), (_, b) in zip(m.state_dict().items(), ref.state_dict().items()):
        assert torch.equal(a, b), k


def test_import_synthetic_state_dict(rng):
    """A plain-weight state dict for the tiny configuration maps onto the
    backbone and runs through the forward."""
    sd = {}

    def conv_entry(prefix, c_in, c_out, k):
        sd[prefix + ".weight"] = rng.standard_normal((c_out, c_in, k)).astype(np.float32) * 0.05
        sd[prefix + ".bias"] = np.zeros(c_out, np.float32)

    def snake_entry(prefix, c):
        sd[prefix + ".alpha"] = np.ones((1, c, 1), np.float32)

    def unit(prefix, c):
        snake_entry(prefix + ".block.0", c)
        conv_entry(prefix + ".block.1", c, c, 7)
        snake_entry(prefix + ".block.2", c)
        conv_entry(prefix + ".block.3", c, c, 1)

    d = CFG.encoder_dim
    conv_entry("encoder.block.0", 1, d, 7)
    for i, r in enumerate(CFG.encoder_rates, start=1):
        for j in range(3):
            unit(f"encoder.block.{i}.block.{j}", d)
        snake_entry(f"encoder.block.{i}.block.3", d)
        conv_entry(f"encoder.block.{i}.block.4", d, 2 * d, 2 * r)
        d *= 2
    snake_entry(f"encoder.block.{len(CFG.encoder_rates) + 1}", d)
    conv_entry(f"encoder.block.{len(CFG.encoder_rates) + 2}", d, CFG.latent_dim, 3)
    d = CFG.decoder_dim
    conv_entry("decoder.model.0", CFG.latent_dim, d, 7)
    for i, r in enumerate(CFG.decoder_rates, start=1):
        snake_entry(f"decoder.model.{i}.block.0", d)
        sd[f"decoder.model.{i}.block.1.weight"] = (
            rng.standard_normal((d, d // 2, 2 * r)).astype(np.float32) * 0.05)
        sd[f"decoder.model.{i}.block.1.bias"] = np.zeros(d // 2, np.float32)
        for j in (2, 3, 4):
            unit(f"decoder.model.{i}.block.{j}", d // 2)
        d //= 2
    snake_entry(f"decoder.model.{len(CFG.decoder_rates) + 1}", d)
    conv_entry(f"decoder.model.{len(CFG.decoder_rates) + 2}", d, 1, 7)
    for i in range(CFG.n_codebooks):
        p = f"quantizer.quantizers.{i}"
        conv_entry(p + ".in_proj", CFG.latent_dim, CFG.codebook_dim, 1)
        conv_entry(p + ".out_proj", CFG.codebook_dim, CFG.latent_dim, 1)
        sd[p + ".codebook.weight"] = rng.standard_normal(
            (CFG.codebook_size, CFG.codebook_dim)).astype(np.float32)

    m = dac_import.import_torch_dac_state_dict(sd, CFG)
    x = torch.from_numpy(rng.standard_normal((1, 1, 3200)).astype(np.float32))
    z = dac.encode(m, CFG, x)
    assert z.shape == (1, CFG.latent_dim, 10)
    zq, codes = m.quantizer.quantize(z, 2)
    assert codes.shape == (1, 10, 2)
    y = dac.decode(m, CFG, zq.float())
    assert y.shape == (1, 1, 3200) and bool(torch.isfinite(y).all())
    # the transposed up-convolutions keep descript's [C_in, C_out, k]
    w = sd["decoder.model.1.block.1.weight"]
    assert np.array_equal(m.decoder.blocks[0].up.weight.detach().numpy(), w)
