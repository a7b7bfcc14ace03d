"""Multi-process runs of the data-parallel mesh, and the multi-chip dry run.

``dryrun_multichip(n)`` is the counterpart of the JAX package's
``__graft_entry__.py::dryrun_multichip``: on ``n`` ranks, a sharded
``train_codec`` step (dropout and the EMA codebook step on), the same step on
the hybrid (dcn=2) mesh giving the flat mesh's loss, a sharded PLC step with
the token mask sharded beside the batch, and batch-sharded serving against
the meshless codec. The ranks are NCCL ranks, one a card, where the machine
has ``n`` cards, else gloo ranks on the CPU.

``run_ranks(n, specs, work_dir)`` runs cases (training steps, serving
calls, whole training runs; ``CASES``) on ``n`` spawned gloo ranks on the
CPU, each case described by a spec file written with ``torch.save``, and
returns every rank's results; ``run_local`` runs a case in this process
without a mesh, the reference a meshed run is held to. The rank workers live
here, in a module that imports no JAX, so that spawned children start fast.
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..core.config import CodecConfig, DacConfig, PLCConfig, PredictorConfig, RVQConfig, TrainConfig
from ..eval.serving import StreamingCodec, StreamingConcealer
from ..models import allpred_ar
from ..plc import masks, model as plc_model, train as plc_train
from ..train import loop, pretrain_backbone as pb
from . import mesh as pmesh


def spawn(n: int, target: str, args: tuple, init_file: str, cuda: bool = False) -> None:
    """Run ``target(*args)``, a function of this module named by a string,
    on ``n`` spawned ranks that share the process group of ``init_file``:
    NCCL, rank r on card r, with ``cuda``, else gloo on the CPU. Raises if a
    rank fails."""
    mp.start_processes(_rank_main, args=(n, init_file, cuda, target, args), nprocs=n,
                       join=True, start_method="spawn")


def _rank_main(rank: int, n: int, init_file: str, cuda: bool, target: str,
               args: tuple) -> None:
    torch.set_num_threads(1)            # n ranks share the host's cores
    device = torch.device("cuda", rank) if cuda else torch.device("cpu")
    pmesh.distributed_init("file://" + init_file, n, rank, device=device)
    try:
        globals()[target](*args)
    finally:
        dist.destroy_process_group()


# ------------------------------------------------------------------ cases

def _mesh(kind) -> Optional[pmesh.Mesh]:
    """None, ("flat",), ("flat", data, model) or ("hybrid", dcn)."""
    if kind is None:
        return None
    if kind[0] == "hybrid":
        return pmesh.create_hybrid_mesh(dcn=kind[1])
    return pmesh.create_mesh(*kind[1:])


def _dev(mesh: Optional[pmesh.Mesh]) -> torch.device:
    return torch.device("cpu") if mesh is None else mesh.device


def _state(module: torch.nn.Module) -> dict:
    return {k: v.detach().cpu().clone() for k, v in module.state_dict().items()}


def case_codec_step(spec: dict, mesh: Optional[pmesh.Mesh]) -> dict:
    """``train/loop.py``'s train step over ``spec["batches"]`` [(a, tc)]
    from ``spec["modules"]``, then its eval step on the first batch."""
    cfg, tcfg, m = spec["cfg"], spec["tcfg"], spec["modules"]
    m.audio_dac.requires_grad_(False)
    m.tactile_dac.requires_grad_(False)
    if mesh is not None:
        pmesh.shard_replicated(mesh, m)
    state = loop.TrainState(m, loop.AdamW(loop.adamw_params(m.head), tcfg,
                                          spec.get("steps_per_epoch", 1)))
    step, eval_step = loop.make_step_fns(cfg, tcfg, mesh)
    put = lambda b: loop.put_batch(b, _dev(mesh), mesh)  # noqa: E731
    metrics = [step(state, *put(b), spec["base_seed"], do_ema=spec["do_ema"])
               for b in spec["batches"]]
    return {"metrics": torch.stack(metrics).cpu(), "head": _state(m.head),
            "eval": eval_step(m, *put(spec["batches"][0])).cpu()}


def case_plc_step(spec: dict, mesh: Optional[pmesh.Mesh]) -> dict:
    """``plc/train.py``'s train step (or its latent step with
    ``spec["latent"]``) over ``spec["batches"]`` [(a, tc, mask)], then its
    eval step on the first batch."""
    cfg, tcfg, head, bb = spec["cfg"], spec["tcfg"], spec["head"], spec["backbones"]
    for b in bb.values():
        b.requires_grad_(False)
    if mesh is not None:
        pmesh.shard_replicated(mesh, [head, *bb.values()])
    state = plc_train.PLCTrainState(head, loop.AdamW(list(head.parameters()), tcfg, 1))
    step, eval_step, latent_step = plc_train.make_plc_train_step(
        cfg, tcfg, spec["mask_embed"], mesh)
    fn = latent_step if spec.get("latent") else step

    def put(b):
        return pmesh.shard_batch(mesh, b) if mesh is not None else tuple(
            torch.as_tensor(x) for x in b)
    metrics = [fn(state, bb, *put(b), spec["base_seed"]) for b in spec["batches"]]
    return {"metrics": torch.stack(metrics).cpu(), "head": _state(head),
            "eval": eval_step(head, bb, *put(spec["batches"][0])).cpu()}


def case_pretrain_step(spec: dict, mesh: Optional[pmesh.Mesh]) -> dict:
    """``train/pretrain_backbone.py``'s reconstruction step (or the GAN step
    with ``spec["gan"]``) over ``spec["batches"]`` [x], then its eval step."""
    cfg, tcfg, m = spec["cfg"], spec["tcfg"], spec["m"]
    gcfg, d = spec.get("gan"), spec.get("d")
    if mesh is not None:
        pmesh.shard_replicated(mesh, [m] if d is None else [m, d])
    opt = pb.generator_optimizer(m, tcfg, lambda s: tcfg.lr)
    if gcfg is None:
        state = pb.PretrainState(m, opt, vq_counts=spec["counts"].to(_dev(mesh)))
        step, eval_step = pb.make_pretrain_step(cfg, tcfg, mesh=mesh)
    else:
        state = pb.PretrainState(m, opt, d=d, d_opt=pb.disc_optimizer(d, tcfg, gcfg))
        step, _, eval_step = pb.make_gan_pretrain_step(cfg, tcfg, gcfg, mesh=mesh)

    def put(x):
        return pmesh.shard_batch(mesh, x) if mesh is not None else torch.as_tensor(x)
    metrics = [step(state, put(x), spec["base_seed"]) for x in spec["batches"]]
    return {"metrics": torch.stack(metrics).cpu(), "m": _state(m),
            "counts": None if state.vq_counts is None else state.vq_counts.cpu(),
            "d": None if d is None else _state(d),
            "eval": eval_step(m, put(spec["batches"][0])).cpu()}


def case_serve(spec: dict, mesh: Optional[pmesh.Mesh]) -> dict:
    """``StreamingCodec``'s calls on the global batch ``spec["a"]``,
    ``spec["tc"]``."""
    a, tc = spec["a"], spec["tc"]
    sc = StreamingCodec(spec["modules"], batch=a.shape[0], device=_dev(mesh), mesh=mesh,
                        **spec["kw"])
    z_run, codes = sc.encode(a, tc)
    streams = sc.encode_to_bytes(a, tc)
    return {"z_run": z_run.float().cpu(), "codes": codes.cpu(), "streams": streams,
            "y": sc.decode_from_bytes(a, streams).cpu(), "y_z": sc.decode(z_run).cpu()}


def case_conceal(spec: dict, mesh: Optional[pmesh.Mesh]) -> dict:
    """``StreamingConcealer.conceal`` on the global batch."""
    a = spec["a"]
    sc = StreamingConcealer(spec["modules"], batch=a.shape[0], device=_dev(mesh), mesh=mesh,
                            **spec["kw"])
    return {"y": sc.conceal(a, spec["zt"], spec["mask"]).cpu()}


def case_entry(spec: dict, mesh: Optional[pmesh.Mesh]) -> dict:
    """A whole training run through its entry point, ``spec["entry"]`` of
    ``train_codec``, ``train_plc`` and ``pretrain_backbone``, into
    ``spec["out_dir"]`` (the meshless run into ``spec["out_dir"] +
    "_local"``), ``train_codec`` on a latent cache where ``spec`` has one;
    -> its hist and the files written."""
    out_dir = spec["out_dir"] + ("_local" if mesh is None else "")
    batches = spec["batches"]
    kw = dict(out_dir=out_dir, seed=spec["seed"], mesh=mesh, device=_dev(mesh),
              train_batches=lambda ep: iter(batches), val_batches=lambda: iter(batches[:1]),
              log=lambda s: None)
    if "cache" in spec:
        kw.update(cache=spec["cache"], seg_tok=spec["seg_tok"], train_batches=None,
                  val_batches=None)
    if spec["entry"] == "train_codec":
        hist = loop.train_codec(spec["cfg"], spec["tcfg"], spec["backbones"], **kw)
    elif spec["entry"] == "train_plc":
        hist = plc_train.train_plc(spec["cfg"], spec["tcfg"], spec["pcfg"], spec["backbones"],
                                   **kw)
    else:
        hist = pb.pretrain_backbone(spec["cfg"], spec["tcfg"], gan=spec.get("gan"), **kw)
    return {"hist": hist, "files": sorted(os.listdir(out_dir))}


def case_mesh(spec: dict, mesh: Optional[pmesh.Mesh]) -> dict:
    """The meshes of this world: shapes, this rank's coordinates and rows,
    the refusals, and a gather of the ranks' rows."""
    n = dist.get_world_size()
    out: Dict[str, object] = {}
    flat = pmesh.create_mesh()
    out["flat"] = (flat.shape, flat.coords, flat.batch_index)
    x = np.arange(2 * n * 3).reshape(2 * n, 3)
    mine = pmesh.shard_batch(flat, {"x": x, "t": (x[:, 0] > 3,)})
    out["rows"] = mine["x"].tolist()
    out["gathered"] = pmesh.all_gather_batch(flat, mine["x"]).tolist()
    out["gathered_bool"] = pmesh.all_gather_batch(flat, mine["t"][0]).tolist()
    out["broadcast"] = pmesh.shard_replicated(flat, torch.tensor([float(flat.rank)])).item()
    if n % 2 == 0:
        two = pmesh.create_mesh(data=n // 2, model=2)
        out["data_model"] = (two.shape, two.coords, two.batch_index)
        hyb = pmesh.create_hybrid_mesh(dcn=2)
        out["hybrid"] = (hyb.shape, hyb.coords, hyb.batch_index)
        out["hybrid_rows"] = pmesh.shard_batch(hyb, x).tolist()
        out["hybrid_sum"] = pmesh.all_reduce_sum(hyb, torch.tensor([1.0 + flat.rank])).item()
    for bad in (lambda: pmesh.create_mesh(data=n + 1), lambda: pmesh.create_hybrid_mesh(dcn=3)):
        try:
            bad()
            out.setdefault("refused", []).append(None)
        except ValueError as e:
            out.setdefault("refused", []).append(str(e))
    return out


CASES: Dict[str, Callable] = {
    "codec_step": case_codec_step, "plc_step": case_plc_step,
    "pretrain_step": case_pretrain_step, "serve": case_serve, "conceal": case_conceal,
    "entry": case_entry, "mesh": case_mesh,
}


def _run_cases(spec_paths: Sequence[str], out_dir: str) -> None:
    rank = dist.get_rank()
    for i, path in enumerate(spec_paths):
        spec = torch.load(path, weights_only=False)
        out = CASES[spec["kind"]](spec, _mesh(spec.get("mesh")))
        torch.save(out, os.path.join(out_dir, f"case{i}_rank{rank}.pt"))


def run_ranks(n: int, spec_paths: Sequence[str], work_dir: str) -> List[List[dict]]:
    """Every case of ``spec_paths`` on ``n`` gloo ranks of one process group
    (on the CPU), in order; -> results[case][rank]."""
    os.makedirs(work_dir, exist_ok=True)
    spawn(n, "_run_cases", (list(spec_paths), work_dir), os.path.join(work_dir, "pg_init"))
    return [[torch.load(os.path.join(work_dir, f"case{i}_rank{r}.pt"), weights_only=False)
             for r in range(n)] for i in range(len(spec_paths))]


def run_local(spec_path: str) -> dict:
    """The case of ``spec_path`` in this process, without a mesh."""
    spec = torch.load(spec_path, weights_only=False)
    return CASES[spec["kind"]](spec, None)


# ------------------------------------------------------------------ dry run

def dryrun_config() -> CodecConfig:
    """The JAX dry run's configuration: the tiny backbones, an 8-head
    predictor at the latent width, 2 books of 16 codes, 4-token chunks."""
    d = DacConfig().tiny()
    return CodecConfig(dac=d, predictor=PredictorConfig(dim=d.latent_dim, heads=8),
                       rvq=RVQConfig(code_dim=16, n_books=2, n_embed=16), ar_chunk_tok=4)


def _dryrun_rank(out_path: str) -> None:
    n = dist.get_world_size()
    cfg = dryrun_config()
    seg = 3200                                    # 10 latent tokens
    tcfg = TrainConfig(epochs=2, batch=n, seg_sec=seg / cfg.dac.sample_rate)
    rng = np.random.default_rng(7)
    a, tc = (0.3 * rng.standard_normal((2, n, 1, seg))).astype(np.float32)
    res: dict = {"n": n, "backend": dist.get_backend()}

    def codec_step(mesh: pmesh.Mesh) -> float:
        m = allpred_ar.codec_init(cfg, torch.Generator().manual_seed(7))
        out = case_codec_step({"cfg": cfg, "tcfg": tcfg, "modules": m, "batches": [(a, tc)],
                               "base_seed": 1, "do_ema": True}, mesh)
        return float(out["metrics"][0, 0])

    flat = pmesh.create_mesh()
    res["loss"] = codec_step(flat)
    assert np.isfinite(res["loss"]), f"non-finite loss {res['loss']}"
    if n >= 4 and n % 2 == 0:
        res["hybrid_loss"] = codec_step(pmesh.create_hybrid_mesh(dcn=2))
        assert abs(res["hybrid_loss"] - res["loss"]) < 1e-3 * max(1.0, abs(res["loss"])), (
            f"hybrid mesh loss {res['hybrid_loss']} != flat mesh loss {res['loss']}")

    pcfg = PLCConfig()
    t_lat = seg // cfg.dac.hop
    mask = masks.make_token_loss_mask(np.random.default_rng(5), n, t_lat, pcfg.packet_tok,
                                      pcfg.packet_loss_prob)
    pm = plc_model.plc_init(cfg, torch.Generator().manual_seed(11), n_layers=2)
    out = case_plc_step({"cfg": cfg, "tcfg": tcfg, "head": pm.head, "mask_embed": True,
                         "backbones": {"audio": pm.audio_dac, "tactile": pm.tactile_dac},
                         "batches": [(a, tc, mask)], "base_seed": 2}, flat)
    res["plc_loss"] = float(out["metrics"][0, 0])
    assert np.isfinite(res["plc_loss"]), f"non-finite PLC loss {res['plc_loss']}"

    m = allpred_ar.codec_init(cfg, torch.Generator().manual_seed(7))
    sc = StreamingCodec(m, batch=n, frame_sec=seg / cfg.dac.sample_rate, fast=False,
                        compute_dtype=torch.float32, mesh=flat)
    z_run, codes = sc.encode(a, tc)
    y = sc.decode(z_run)
    assert tuple(y.shape) == (n, 1, seg) and bool(torch.isfinite(y).all()), \
        "serving output not finite or mis-shaped"
    # the meshless codec on this rank alone (no collective)
    ref = StreamingCodec(m, batch=n, frame_sec=seg / cfg.dac.sample_rate, fast=False,
                         compute_dtype=torch.float32, device=flat.device)
    res["serving_code_agreement"] = float((ref.encode(a, tc)[1] == codes).float().mean())
    assert res["serving_code_agreement"] > 0.9, res["serving_code_agreement"]
    if flat.rank == 0:
        with open(out_path, "w") as f:
            json.dump(res, f)


def dryrun_multichip(n_devices: int) -> dict:
    """The multi-chip dry run (the module's docstring) on ``n_devices``
    ranks; -> rank 0's numbers {"n", "backend", "loss", "hybrid_loss" (4+
    ranks, even), "plc_loss", "serving_code_agreement"}. Raises if a leg
    fails."""
    cuda = torch.cuda.is_available() and torch.cuda.device_count() >= n_devices
    with tempfile.TemporaryDirectory() as d:
        out = os.path.join(d, "dryrun.json")
        spawn(n_devices, "_dryrun_rank", (out,), os.path.join(d, "pg_init"), cuda=cuda)
        with open(out) as f:
            res = json.load(f)
    print(f"[dryrun_multichip] n={n_devices} ({res['backend']}) ok: loss {res['loss']:.4f}"
          + (f", hybrid dcn=2 {res['hybrid_loss']:.4f}" if "hybrid_loss" in res else "")
          + f", plc {res['plc_loss']:.4f}, serving code agreement "
          f"{res['serving_code_agreement']:.3f}")
    return res
