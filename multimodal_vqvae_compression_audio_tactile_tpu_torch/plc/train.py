"""PLC trainer: the codec trainer's loop without the VQ, and the inpainting
decoder's fine-tune.

Port of the JAX package's ``plc/train.py``. ``train_plc`` trains a PLC head
against frozen backbones on uniform or category masks (made on the host by
``plc/masks.py`` from numpy generators, so both packages draw the same
masks): the codec loss of the concealed waveform plus the two masked terms
(``masked_latent_rel_mse``, ``masked_time_rel_mse``) at ``LossConfig``'s
``w_plc_latent`` and ``w_plc_masked``, optionally after
``latent_pretrain_epochs`` of the decoder-free latent regression. It writes
``last``/``best``/``hist.json`` and a ``meta.json`` whose ``plc`` entry
``plc_config_from_meta`` reads back. ``finetune_inpaint_decoder`` then trains
a copy of the tactile decoder alone on concealed latents (the predictor's
fill detached) and writes ``dec_plc.msgpack`` (best) and
``dec_plc_last.msgpack``, which the evaluators take as ``dec_ft``.

The optimizer is the codec trainer's (``train/loop.py::AdamW``: optax's
clip, AdamW and finite gate, on the device), over every head leaf (the
decoder's, in the fine-tune). A step takes waveform batches (a, tc) or
cached latents ((qa, zt), tc) from ``train/latent_cache.py``. On the card the
frozen encoders run under ``no_grad`` through K1 (48 launches a waveform
step in fp32); the tactile decoder, whether frozen or trained, runs its
plain stacks with autograd (``Decoder.forward_train``); everything runs in
true fp32. Every entry point runs on the card unless ``device="cpu"``.

``train_plc(mesh=...)`` is data-parallel as ``train/loop.py::train_codec``:
each rank runs its rows of the global batch (and of its mask, drawn on the
host for the whole batch), the gradients are all-reduced before the
optimizer, the dropout draws the global batch's masks, and the two masked
terms divide the global batch's sums (``parallel/mesh.py::batch_sum``), so
the loss and every metric are the meshless step's.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from ..convert import (decoder_leaves, decoder_tree, load_tolerant, plc_head_leaves,
                       plc_head_tree)
from ..core import rng
from ..core.config import CodecConfig, PLCConfig, TrainConfig, asdict_jsonable
from ..core.precision import deterministic_steps, fp32_exact
from ..data import wire
from ..eval.serving import resolve_device
from ..losses.losses import codec_loss
from ..models import allpred_ar
from ..parallel import mesh as pmesh
from ..train import checkpoint as ckpt
from ..train.loop import AdamW, put_batch, step_generator
from ..utils import artifacts
from . import masks
from . import model as plc_model
from .model import PLCHead


def plc_config_from_meta(run_dir: str, default: PLCConfig = PLCConfig()) -> PLCConfig:
    """The training-time ``PLCConfig`` from ``run_dir/meta.json``'s ``plc``
    entry; a missing file or key keeps ``default``'s field."""
    p = os.path.join(run_dir, "meta.json")
    if not os.path.exists(p):
        return default
    with open(p) as f:
        meta = json.load(f)
    d = meta.get("plc", {})
    names = {f.name for f in dataclasses.fields(PLCConfig)}
    kw = {k: v for k, v in d.items() if k in names}
    if "cat_probs" in kw:
        kw["cat_probs"] = tuple(kw["cat_probs"])
    for k in ("cat_burst_ms", "cat_n_bursts"):
        if k in kw:
            kw[k] = tuple(tuple(x) for x in kw[k])
    return dataclasses.replace(default, **kw)


class PLCTrainState:
    """The trained PLC head, its optimizer and the step count that seeds the
    per-step dropout generator."""

    def __init__(self, head: PLCHead, opt: AdamW, step: int = 0):
        self.head, self.opt, self.step = head, opt, step


def masked_latent_rel_mse(z_pred: torch.Tensor, z_tgt: torch.Tensor, m: torch.Tensor,
                          eps: float = 1e-8) -> torch.Tensor:
    """Relative squared error of the predicted latents on the masked tokens,
    over the masked latents' own power (scale-free); both sums over the
    global batch inside ``parallel/mesh.py::batch_scope``."""
    d = pmesh.batch_sum(torch.sum(((z_pred - z_tgt) ** 2) * m))
    p = pmesh.batch_sum(torch.sum((z_tgt ** 2) * m))
    return d / torch.clamp(p, min=eps)


def masked_time_rel_mse(y_hat: torch.Tensor, tgt: torch.Tensor, m: torch.Tensor,
                        hop: int, eps: float = 1e-8) -> torch.Tensor:
    """Power-normalised squared error over the masked sample spans (token t
    covers samples [t * hop, (t + 1) * hop)): 10^(-SNR_masked / 10), the
    evaluator's masked-PSNR objective; global sums as
    ``masked_latent_rel_mse``'s."""
    sm = torch.repeat_interleave(m, hop, dim=-1)[..., :y_hat.shape[-1]]
    d = pmesh.batch_sum(torch.sum(((y_hat - tgt) ** 2) * sm))
    p = pmesh.batch_sum(torch.sum((tgt ** 2) * sm))
    return d / torch.clamp(p, min=eps)


def _latents(backbones: dict, cfg: CodecConfig, a, tc) -> tuple:
    """(qa, zt): the cached pair, or the frozen encoders' on waveforms."""
    if isinstance(a, tuple):
        return a
    with torch.no_grad(), fp32_exact(tc.dtype == torch.float32):
        return allpred_ar.backbone_latents(allpred_ar.codec_of(
            backbones["audio"], backbones["tactile"], None, cfg), wire.decode_wave(a), tc, cfg)


def make_plc_train_step(cfg: CodecConfig, tcfg: TrainConfig, mask_embed: bool = False,
                        mesh: Optional[pmesh.Mesh] = None):
    """-> (train_step, eval_step, latent_train_step):
    ``train_step(state, backbones, a, tc, mask, base_seed) -> metrics``,
    ``eval_step(head, backbones, a, tc, mask) -> metrics`` and the
    decoder-free ``latent_train_step`` (same signature as ``train_step``).
    ``a``: the audio waveform batch or the cached ``(qa, zt)``; ``mask``
    [B, T_lat] bool; metrics: one [3] tensor on the device, [total, masked
    latent rel. MSE, masked time rel. MSE]. ``base_seed`` None: no dropout.
    With ``mesh`` the batches are this rank's rows and the metrics the
    global batch's."""
    lw = tcfg.loss

    def loss_fn(head, backbones, a, tc, mask, gen) -> torch.Tensor:
        tc = wire.decode_wave(tc)
        if isinstance(a, tuple):
            out = plc_model.forward_step_latents(head, backbones["tactile"], cfg, a[0], a[1],
                                                 tc, mask, mask_embed, dropout=gen, train=True)
        else:
            m = plc_model.plc_of(backbones["audio"], backbones["tactile"], head, cfg)
            out = plc_model.forward_step(m, wire.decode_wave(a), tc, mask, mask_embed, cfg=cfg,
                                         dropout=gen, train=True)
        total, _ = codec_loss(out.y_hat, out.tgt, w_wav_l1=lw.w_wav_l1, w_stft=lw.w_stft,
                              w_melcos=lw.w_melcos, sr=tcfg.target_sr)
        # both masked terms are measured always, and weighted into the loss
        lat = masked_latent_rel_mse(out.z_pred, out.z_tgt, out.latent_mask)
        tmse = masked_time_rel_mse(out.y_hat, out.tgt, out.latent_mask, cfg.dac.hop)
        return torch.stack([total + lw.w_plc_latent * lat + lw.w_plc_masked * tmse, lat, tmse])

    def latent_loss_fn(head, backbones, a, tc, mask, gen) -> torch.Tensor:
        # the decoder-free phase: only the masked latent regression trains;
        # tmse cannot be measured without a decode and reads 0
        qa, zt = _latents(backbones, cfg, a, wire.decode_wave(tc))
        z_pred, m = plc_model.predict_latents(head, cfg, qa, zt, mask, mask_embed,
                                              dropout=gen, train=True)
        lat = masked_latent_rel_mse(z_pred, zt, m)
        w = max(lw.w_plc_latent, 1e-3)             # the phase trains even at weight 0
        return torch.stack([w * lat, lat, torch.zeros_like(lat)])

    def global_metrics(metrics: torch.Tensor) -> torch.Tensor:
        return metrics if mesh is None else pmesh.all_reduce_mean(mesh, metrics)

    def stepper(fn):
        @deterministic_steps()
        def step(state: PLCTrainState, backbones: dict, a, tc, mask,
                 base_seed: Optional[int]) -> torch.Tensor:
            gen = (None if base_seed is None
                   else step_generator(base_seed, state.step, 0, tc.device))
            if gen is not None and mesh is not None:
                gen = rng.BatchShard(gen, mesh.batch_index, mesh.batch_shards)
            state.head.zero_grad(set_to_none=True)
            with pmesh.batch_scope(mesh):
                metrics = fn(state.head, backbones, a, tc, mask, gen)
                metrics[0].backward()
            pmesh.reduce_grads(mesh, state.opt.params)
            state.opt.step()
            state.step += 1
            return global_metrics(metrics.detach())
        return step

    @torch.no_grad()
    @deterministic_steps()
    def eval_step(head: PLCHead, backbones: dict, a, tc, mask) -> torch.Tensor:
        with pmesh.batch_scope(mesh):
            return global_metrics(loss_fn(head, backbones, a, tc, mask, None))

    return stepper(loss_fn), eval_step, stepper(latent_loss_fn)


def make_decoder_ft_step(cfg: CodecConfig, tcfg: TrainConfig, mask_embed: bool = False,
                         w_masked_ft: float = 1.0):
    """Inpainting-decoder fine-tune steps: -> (ft_step(dec, opt, head,
    backbones, a, tc, mask, gen) -> metrics, ft_eval(dec, head, backbones,
    a, tc, mask) -> metrics), metrics [total, 0, masked time rel. MSE].

    Only ``dec`` (a tactile decoder) trains; the predictor and the encoders
    are frozen. The decoder only saw clean latents in pretraining; here it
    decodes ``z_filled`` (the true latents with the predictor's tokens
    spliced in at the lost positions, detached) and learns to use the context
    around a filled span. Loss: the codec loss over the whole signal, plus
    ``w_masked_ft`` times the masked-span time rel. MSE."""
    lw = tcfg.loss

    def loss_fn(dec, head, backbones, a, tc, mask, gen) -> torch.Tensor:
        tc = wire.decode_wave(tc)
        qa, zt = _latents(backbones, cfg, a, tc)
        with torch.no_grad():                       # decoder-only gradients
            z_pred, m = plc_model.predict_latents(head, cfg, qa, zt, mask, mask_embed,
                                                  dropout=gen, train=True)
            z_filled = torch.where(m, z_pred, zt * ~m)
        y_hat = dec.forward_train(z_filled, cfg.dac)
        T = min(y_hat.shape[-1], tc.shape[-1])
        fin = lambda x: torch.nan_to_num(x[..., :T], nan=0.0, posinf=0.0, neginf=0.0)  # noqa: E731
        y_hat, tgt = fin(y_hat), fin(tc)
        total, _ = codec_loss(y_hat, tgt, w_wav_l1=lw.w_wav_l1, w_stft=lw.w_stft,
                              w_melcos=lw.w_melcos, sr=tcfg.target_sr)
        tmse = masked_time_rel_mse(y_hat, tgt, m, cfg.dac.hop)
        return torch.stack([total + w_masked_ft * tmse, torch.zeros_like(tmse), tmse])

    @deterministic_steps()
    def ft_step(dec, opt: AdamW, head, backbones, a, tc, mask, gen) -> torch.Tensor:
        dec.zero_grad(set_to_none=True)
        metrics = loss_fn(dec, head, backbones, a, tc, mask, gen)
        metrics[0].backward()
        opt.step()
        return metrics.detach()

    @torch.no_grad()
    @deterministic_steps()
    def ft_eval(dec, head, backbones, a, tc, mask) -> torch.Tensor:
        return loss_fn(dec, head, backbones, a, tc, mask, None)

    return ft_step, ft_eval


def _make_mask(rng: np.random.Generator, batch: int, t_lat: int, pcfg: PLCConfig,
               mode: str, tokens_per_sec: float) -> np.ndarray:
    if mode == "uniform":
        return masks.make_token_loss_mask(rng, batch, t_lat, pcfg.packet_tok,
                                          pcfg.packet_loss_prob)
    return masks.make_category_token_loss_mask(rng, batch, t_lat, tokens_per_sec, pcfg)


def _frozen(backbones: dict, dev: torch.device) -> dict:
    return {k: bb.to(dev).requires_grad_(False) for k, bb in backbones.items()}


def _epoch_means(step_parts: list, val_parts: list, dev) -> np.ndarray:
    """[[train means], [val means]] of the [3] metric vectors, in one copy."""
    def mean(parts):
        return torch.stack(parts).mean(0) if parts else torch.zeros(3, device=dev)
    return torch.stack([mean(step_parts), mean(val_parts)]).cpu().numpy()


def _masked_snr_db(tmse: float) -> float:
    return -10.0 * float(np.log10(max(tmse, 1e-12)))


def finetune_inpaint_decoder(
    cfg: CodecConfig,
    tcfg: TrainConfig,
    pcfg: PLCConfig,
    backbones: dict,
    head: PLCHead,
    train_batches: Callable[[int], Iterable],
    val_batches: Callable[[], Iterable],
    out_dir: str,
    mode: str = "uniform",
    seed: int = 7,
    epochs: Optional[int] = None,
    w_masked_ft: float = 1.0,
    resume: bool = False,
    log: Callable[[str], None] = print,
    device=None,
) -> dict:
    """Fine-tune a copy of the tactile decoder on concealed latents (the
    predictor ``head`` frozen); -> hist. Writes ``dec_plc.msgpack`` (the best
    by validation loss, written when it improves) and ``dec_plc_last.msgpack``
    into ``out_dir``: decoder trees, read by ``convert.load_decoder`` and by
    the JAX package. The backbones and the head are left as they were."""
    assert mode in ("uniform", "category")
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    epochs = epochs or tcfg.epochs
    steps_per_epoch = max(1, sum(1 for _ in train_batches(0)))
    backbones = _frozen(backbones, dev)
    head = head.to(dev)
    dec = copy.deepcopy(backbones["tactile"].decoder).requires_grad_(True)
    start_epoch = 1
    hist = {"train": [], "val": [], "tmse": [], "val_masked_snr_db": []}
    last_path = os.path.join(out_dir, "dec_plc_last.msgpack")
    if resume and os.path.exists(last_path):
        last_epoch, resumed_hist = load_tolerant(decoder_leaves(dec), last_path)
        start_epoch = last_epoch + 1
        if resumed_hist:
            hist.update({k: list(v) for k, v in resumed_hist.items() if k in hist})
        log(f"[plc-decft:{mode}] resume from {last_path} at epoch {last_epoch}")

    opt = AdamW(list(dec.parameters()), dataclasses.replace(tcfg, epochs=epochs),
                steps_per_epoch, sched_offset_steps=(start_epoch - 1) * steps_per_epoch,
                betas=(tcfg.adam_b1, tcfg.adam_b2))
    ft_step, ft_eval = make_decoder_ft_step(cfg, tcfg, pcfg.mask_embed, w_masked_ft)

    t_lat = int(round(tcfg.seg_sec * cfg.dac.tokens_per_sec))
    tps = cfg.dac.tokens_per_sec
    best_val = min(hist["val"]) if hist["val"] else float("inf")
    mask_rng = np.random.default_rng(seed + 31)
    base_seed = seed + 32
    acp = ckpt.AsyncCheckpointer()

    def batch_with_mask(b, rng):
        a, tc = put_batch(b, dev)
        mask = _make_mask(rng, tc.shape[0], t_lat, pcfg, mode, tps)
        return a, tc, torch.from_numpy(mask).to(dev)

    try:
        with fp32_exact(dev.type == "cuda"):
            for ep in range(start_epoch, epochs + 1):
                t0 = time.time()
                step_parts = []
                for b in train_batches(ep):
                    gen = step_generator(base_seed, len(step_parts) + ep * 10000, 0, dev)
                    step_parts.append(ft_step(dec, opt, head, backbones,
                                              *batch_with_mask(b, mask_rng), gen))
                val_rng = np.random.default_rng(seed + 999)
                val_parts = [ft_eval(dec, head, backbones, *batch_with_mask(b, val_rng))
                             for b in val_batches()]
                packed = _epoch_means(step_parts, val_parts, dev)
                hist["train"].append(float(packed[0, 0]))
                hist["tmse"].append(float(packed[0, 2]))
                v = float(packed[1, 0])
                hist["val"].append(v)
                msnr = _masked_snr_db(float(packed[1, 2]))
                hist["val_masked_snr_db"].append(msnr)
                log(f"[plc-decft:{mode}] epoch {ep:03d} | train {hist['train'][-1]:.4f} | "
                    f"val {v:.4f} | mSNR {msnr:.2f} dB | {time.time() - t0:.1f}s")
                acp.save(last_path, decoder_tree(dec), ep, hist)
                if v + 1e-6 < best_val:
                    best_val = v
                    # written at once: a run cut short keeps its best decoder
                    acp.save(os.path.join(out_dir, "dec_plc.msgpack"), decoder_tree(dec), ep,
                             hist)
                    log("new best decoder")
    finally:
        acp.close()
    return hist


def train_plc(
    cfg: CodecConfig,
    tcfg: TrainConfig,
    pcfg: PLCConfig,
    backbones: dict,
    train_batches: Callable[[int], Iterable],
    val_batches: Callable[[], Iterable],
    out_dir: str,
    mode: str = "uniform",
    seed: int = 7,
    mesh: Optional[pmesh.Mesh] = None,
    steps_per_epoch: Optional[int] = None,
    save_every: int = 1,
    resume: bool = False,
    latent_pretrain_epochs: int = 0,
    log: Callable[[str], None] = print,
    on_epoch: Optional[Callable[[int, PLCHead], None]] = None,
    device=None,
) -> dict:
    """Train a PLC head of ``pcfg.n_layers`` blocks; -> hist. Writes
    ``last.msgpack`` (every ``save_every`` epochs and at the end),
    ``best.msgpack`` (the best validation loss after
    ``tcfg.best_after_epoch``), ``hist.json``, ``meta.json`` (mode, the
    ``PLCConfig``, the loss weights, tokens/s, epochs) and the loss curves'
    ``curves.png`` (one line instead where matplotlib is missing). ``resume`` continues
    from ``last.msgpack`` with the schedule shifted to its epoch. The first
    ``latent_pretrain_epochs`` train the decoder-free latent regression;
    validation always scores the full loss. ``on_epoch(ep, head)`` is called
    after each epoch's bookkeeping. The backbones are frozen and moved to
    the device (the card unless ``device="cpu"``; the mesh's with
    ``mesh``). ``mesh``: data parallelism (the module's docstring), made
    by ``parallel/mesh.py::mesh_for_batch`` when None; rank 0 alone writes
    the files."""
    assert mode in ("uniform", "category")
    if mesh is None:
        mesh = pmesh.mesh_for_batch(tcfg.batch)
    else:
        mesh.shard_size(tcfg.batch)          # raises where the batch does not divide
    dev = mesh.device if mesh is not None else resolve_device(device)
    writer = mesh is None or mesh.rank == 0
    os.makedirs(out_dir, exist_ok=True)
    head = plc_model.plc_head_init(cfg, torch.Generator().manual_seed(seed),
                                   n_layers=pcfg.n_layers)
    if steps_per_epoch is None:
        steps_per_epoch = max(1, sum(1 for _ in train_batches(0)))

    start_epoch = 1
    resumed_hist = None
    last_path = os.path.join(out_dir, "last.msgpack")
    if resume and os.path.exists(last_path):
        last_epoch, resumed_hist = load_tolerant(plc_head_leaves(head), last_path)
        start_epoch = last_epoch + 1
        log(f"[plc:{mode}] resume from {last_path} at epoch {last_epoch}")
    head = head.to(dev)
    offset = (start_epoch - 1) * steps_per_epoch

    def fresh_optimizer() -> AdamW:
        return AdamW(list(head.parameters()), tcfg, steps_per_epoch, sched_offset_steps=offset)

    backbones = _frozen(backbones, dev)
    if mesh is not None:
        pmesh.shard_replicated(mesh, [head, *backbones.values()])
    state = PLCTrainState(head, fresh_optimizer())
    train_step, eval_step, latent_step = make_plc_train_step(cfg, tcfg, pcfg.mask_embed, mesh)

    t_lat = int(round(tcfg.seg_sec * cfg.dac.tokens_per_sec))
    tps = cfg.dac.tokens_per_sec
    best_val = float("inf")
    best_head = None
    best_epoch = 0
    hist = {"train": [], "val": [], "lat": [], "tmse": [], "val_masked_snr_db": []}
    if resumed_hist:
        hist.update({k: list(v) for k, v in resumed_hist.items() if k in hist})
        # pad series a pre-schema hist lacks with NaN: every list stays
        # epoch-aligned
        n_ep = len(hist["train"])
        for k, v in hist.items():
            if len(v) < n_ep:
                hist[k] = [float("nan")] * (n_ep - len(v)) + list(v)
        if hist["val"]:
            best_val = min(hist["val"])
    mask_rng = np.random.default_rng(seed)
    base_seed = seed + 1
    acp = ckpt.AsyncCheckpointer()

    def batch_with_mask(b, rng):
        # the mask of the global batch, drawn on the host; then this rank's rows
        mask = _make_mask(rng, np.shape(b[-1])[0], t_lat, pcfg, mode, tps)
        a, tc = put_batch(b, dev, mesh)
        return a, tc, (torch.from_numpy(mask).to(dev) if mesh is None
                       else pmesh.shard_batch(mesh, mask))

    try:
        with fp32_exact(dev.type == "cuda"):
            for ep in range(start_epoch, tcfg.epochs + 1):
                t0 = time.time()
                step_fn = latent_step if ep <= latent_pretrain_epochs else train_step
                step_parts = [step_fn(state, backbones, *batch_with_mask(b, mask_rng), base_seed)
                              for b in train_batches(ep)]
                val_rng = np.random.default_rng(seed + 999)   # the same masks every epoch
                val_parts = [eval_step(head, backbones, *batch_with_mask(b, val_rng))
                             for b in val_batches()]
                packed = _epoch_means(step_parts, val_parts, dev)
                hist["train"].append(float(packed[0, 0]))
                hist["lat"].append(float(packed[0, 1]))
                hist["tmse"].append(float(packed[0, 2]))
                v = float(packed[1, 0])
                hist["val"].append(v)
                # the masked-span SNR that the validation rel. MSE implies
                msnr = _masked_snr_db(float(packed[1, 2]))
                hist["val_masked_snr_db"].append(msnr)
                log(f"[plc:{mode}] epoch {ep:03d} | train {hist['train'][-1]:.4f} | "
                    f"val {v:.4f} | lat {hist['lat'][-1]:.3f} | mSNR {msnr:.2f} dB | "
                    f"{time.time() - t0:.1f}s")

                # divergence recovery, not in the latent phase (its train
                # totals are on another scale than the full-loss val)
                if (ep > latent_pretrain_epochs and best_head is not None
                        and np.isfinite(hist["train"][-1])
                        and hist["train"][-1] > 5.0 * max(best_val, 1e-9)):
                    log(f"[plc:{mode}] divergence at epoch {ep}: restoring best "
                        f"(epoch {best_epoch}), resetting optimizer")
                    with torch.no_grad():
                        for p, b in zip(head.state_dict().values(), best_head.values()):
                            p.copy_(b)
                    state.opt = fresh_optimizer()

                if writer and (ep % save_every == 0 or ep == tcfg.epochs):
                    acp.save(last_path, plc_head_tree(head), ep, hist)
                if v + 1e-6 < best_val and ep > tcfg.best_after_epoch:
                    best_val, best_epoch = v, ep
                    best_head = {k: t.detach().clone() for k, t in head.state_dict().items()}
                    log("new best")
                if on_epoch is not None:
                    on_epoch(ep, head)

        if best_head is not None and writer:
            best = PLCHead(cfg, pcfg.n_layers).to(dev)
            best.load_state_dict(best_head)
            acp.save(os.path.join(out_dir, "best.msgpack"), plc_head_tree(best), best_epoch,
                     hist)
    finally:
        acp.close()
    if not writer:
        return hist
    artifacts.write_meta(out_dir, {
        "mode": mode,
        "plc": asdict_jsonable(pcfg),
        "loss": asdict_jsonable(tcfg.loss),     # the w_plc_* terms trained with
        "tokens_per_sec": tps,
        "epochs": tcfg.epochs,
    })
    artifacts.write_hist(out_dir, hist)
    if artifacts.have_matplotlib():
        artifacts.write_curves(out_dir, hist, title=f"PLC ({mode})")
    else:
        log(f"[plc:{mode}] " + artifacts.not_drawn("curves.png"))
    return hist
