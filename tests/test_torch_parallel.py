"""The port's data-parallel mesh (``parallel/mesh.py``) on spawned gloo ranks.

The mesh's shapes, coordinates and refusals against the JAX package's mesh
on its 8 virtual CPU devices; ``pad_batch_to_multiple`` against JAX's;
``distributed_init`` a no-op in a plain process; the meshed
``StreamingCodec`` and ``StreamingConcealer`` on 2 and 4 ranks, flat and
2 x 2 hybrid, against the meshless port on the same weights and inputs
(tiny configuration, fp32): codes and byte streams equal, latents within
1e-6, waveforms within 1e-5 of their scale (a batch split over ranks changes
the CPU convolutions' sum order: 6e-8 of a 0.055 waveform seen); a batch
that does not divide the mesh raises; and ``dryrun_multichip(4)``. The
ranks run ``parallel/dryrun.py``'s cases, each from a spec file under
``tmp_path`` (a file ``init_method``).
"""

import jax
import numpy as np
import pytest
import torch

from multimodal_vqvae_compression_audio_tactile_tpu.parallel import mesh as jmesh
from multimodal_vqvae_compression_audio_tactile_tpu_torch.core.config import CodecConfig
from multimodal_vqvae_compression_audio_tactile_tpu_torch.eval.serving import (
    StreamingCodec, StreamingConcealer)
from multimodal_vqvae_compression_audio_tactile_tpu_torch.models import allpred_ar
from multimodal_vqvae_compression_audio_tactile_tpu_torch.parallel import dryrun
from multimodal_vqvae_compression_audio_tactile_tpu_torch.parallel import mesh as pmesh
from multimodal_vqvae_compression_audio_tactile_tpu_torch.plc import masks
from multimodal_vqvae_compression_audio_tactile_tpu_torch.plc import model as plc

FRAME = 3200
MESHES = [(2, ("flat",)), (4, ("flat",)), (4, ("hybrid", 2))]


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def save(path, spec) -> str:
    torch.save(spec, path)
    return str(path)


# ---------------------------------------------------------------- the mesh

def test_distributed_init_single_process_noop():
    assert not torch.distributed.is_initialized()
    assert pmesh.distributed_init() == 1
    assert not torch.distributed.is_initialized()


def test_pad_batch_to_multiple_matches_jax():
    x = np.arange(10, dtype=np.float32).reshape(5, 2)
    tree = {"x": x, "y": (x[:, 0].astype(np.int32),)}
    for mult in (1, 4, 5, 8):
        got, n = pmesh.pad_batch_to_multiple(tree, mult)
        want, jn = jmesh.pad_batch_to_multiple(tree, mult)
        assert n == jn == 5
        for g, w in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
            np.testing.assert_array_equal(g, w)
    assert pmesh.pad_batch_to_multiple([], 4) == ([], 0)


def test_axis_names_match_jax():
    assert (pmesh.DATA_AXIS, pmesh.MODEL_AXIS, pmesh.DCN_AXIS, pmesh.BATCH_AXES) == (
        jmesh.DATA_AXIS, jmesh.MODEL_AXIS, jmesh.DCN_AXIS, jmesh.BATCH_AXES)


def _jax_error(fn) -> str:
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


@pytest.mark.parametrize("n", [2, 4])
def test_mesh_shapes_coords_and_collectives_match_jax(tmp_path, n):
    res = dryrun.run_ranks(n, [save(tmp_path / "s.pt", {"kind": "mesh"})], str(tmp_path))[0]
    devices = jax.devices()[:n]
    flat = jmesh.create_mesh(devices)
    x = np.arange(2 * n * 3).reshape(2 * n, 3)
    for r, out in enumerate(res):
        shape, coords, index = out["flat"]
        assert shape == dict(flat.shape) == {"data": n, "model": 1}
        assert coords == {"data": r, "model": 0} and index == r
        np.testing.assert_array_equal(out["rows"], x[2 * r:2 * r + 2])
        np.testing.assert_array_equal(out["gathered"], x)
        assert out["gathered_bool"] == (x[:, 0] > 3).tolist()
        assert out["broadcast"] == 0.0
        two = jmesh.create_mesh(devices, data=n // 2, model=2)
        shape, coords, index = out["data_model"]
        assert shape == dict(two.shape)
        # JAX's device at (data, model) has id data * 2 + model: rank r's place
        ids = np.vectorize(lambda d: d.id)(two.devices)
        assert ids[coords["data"], coords["model"]] == r and index == coords["data"]
        hyb = jmesh.create_hybrid_mesh(dcn=2, devices=devices)
        shape, coords, index = out["hybrid"]
        assert shape == dict(hyb.shape) == {"dcn": 2, "data": n // 2, "model": 1}
        ids = np.vectorize(lambda d: d.id)(hyb.devices)
        assert ids[coords["dcn"], coords["data"], coords["model"]] == r and index == r
        rows = x.shape[0] // n
        np.testing.assert_array_equal(out["hybrid_rows"], x[r * rows:(r + 1) * rows])
        assert out["hybrid_sum"] == sum(1.0 + k for k in range(n))
        assert out["refused"] == [
            _jax_error(lambda: jmesh.create_mesh(devices, data=n + 1)),
            _jax_error(lambda: jmesh.create_hybrid_mesh(dcn=3, devices=devices))]


def test_create_mesh_needs_an_initialised_group():
    with pytest.raises(RuntimeError, match="distributed_init"):
        pmesh.create_mesh()
    assert pmesh.mesh_for_batch(4) is None


# ---------------------------------------------------------------- serving

def _mesh_stub(shards: int) -> pmesh.Mesh:
    """A mesh's shape alone (no process group): enough for the checks that
    come before any collective."""
    return pmesh.Mesh({"data": shards, "model": 1}, {"data": 0, "model": 0}, 0,
                      torch.device("cpu"), "gloo")


def test_meshed_batch_must_divide():
    cfg = CodecConfig().tiny()
    m = allpred_ar.codec_init(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="not divisible by data axis 2"):
        StreamingCodec(m, batch=3, frame_sec=FRAME / 24000, mesh=_mesh_stub(2))
    pm = plc.plc_init(cfg, torch.Generator().manual_seed(0), 1)
    with pytest.raises(ValueError, match="not divisible by data axis 4"):
        StreamingConcealer(pm, batch=6, frame_sec=FRAME / 24000, mesh=_mesh_stub(4))
    with pytest.raises(ValueError, match="not the mesh's"):
        StreamingCodec(m, batch=2, frame_sec=FRAME / 24000, device="cuda",
                       mesh=_mesh_stub(2))


@pytest.fixture(scope="module")
def serving(tmp_path_factory):
    """The meshless port's serving and concealment on 4 streams, and the
    same calls on each mesh of MESHES."""
    d = tmp_path_factory.mktemp("serving")
    cfg = CodecConfig().tiny()
    rng = np.random.default_rng(0)
    a, tc = (0.3 * rng.standard_normal((2, 4, 1, FRAME))).astype(np.float32)
    kw = dict(frame_sec=FRAME / 24000, fast=False, compute_dtype=torch.float32)
    t_lat = FRAME // cfg.dac.hop
    codec = {"kind": "serve", "modules": allpred_ar.codec_init(
        cfg, torch.Generator().manual_seed(1)), "a": a, "tc": tc, "kw": kw}
    conceal = {"kind": "conceal", "modules": plc.plc_init(cfg, torch.Generator().manual_seed(2),
                                                          2),
               "a": a, "zt": (0.5 * rng.standard_normal((4, cfg.dac.latent_dim, t_lat))
                              ).astype(np.float32),
               "mask": masks.make_token_loss_mask(rng, 4, t_lat, 2, 0.5),
               "kw": dict(kw, mask_embed=True)}
    local = {k: dryrun.run_local(save(d / f"{k}.pt", s))
             for k, s in (("codec", codec), ("conceal", conceal))}
    meshed = {}
    for n in (2, 4):
        specs = [(mesh, kind, save(d / f"{kind}{n}{mesh[0]}.pt", dict(s, mesh=mesh)))
                 for nn, mesh in MESHES if nn == n
                 for kind, s in (("codec", codec), ("conceal", conceal))]
        for (mesh, kind, _), res in zip(specs, dryrun.run_ranks(n, [p for *_, p in specs],
                                                                str(d / f"w{n}"))):
            meshed[(n, mesh, kind)] = res
    return local, meshed


@pytest.mark.parametrize("n,mesh", MESHES, ids=lambda v: str(v))
def test_meshed_codec_matches_meshless(serving, n, mesh):
    local, meshed = serving
    ref = local["codec"]
    for out in meshed[(n, mesh, "codec")]:          # every rank: the global result
        assert torch.equal(out["codes"], ref["codes"])
        assert out["streams"] == ref["streams"]
        torch.testing.assert_close(out["z_run"], ref["z_run"], rtol=0, atol=1e-6)
        for k in ("y", "y_z"):
            scale = float(ref[k].abs().max())
            torch.testing.assert_close(out[k], ref[k], rtol=0, atol=1e-5 * scale)


@pytest.mark.parametrize("n,mesh", MESHES, ids=lambda v: str(v))
def test_meshed_concealer_matches_meshless(serving, n, mesh):
    local, meshed = serving
    ref = local["conceal"]["y"]
    for out in meshed[(n, mesh, "conceal")]:
        assert out["y"].shape == ref.shape == (4, 1, FRAME)
        torch.testing.assert_close(out["y"], ref, rtol=0, atol=1e-5 * float(ref.abs().max()))


# ---------------------------------------------------------------- dry run

def test_dryrun_multichip_4():
    res = dryrun.dryrun_multichip(4)
    assert res["n"] == 4 and res["backend"] == "gloo"
    assert np.isfinite(res["loss"]) and np.isfinite(res["plc_loss"])
    assert abs(res["hybrid_loss"] - res["loss"]) < 1e-3 * max(1.0, abs(res["loss"]))
    assert res["serving_code_agreement"] > 0.9
