"""Backbone pretraining: train the DAC-class codec on waveform reconstruction.

The JAX package's ``train/pretrain_backbone.py``. Two recipes:

- reconstruction: ``codec_loss`` (0.55 L1 + 0.25 MR-STFT + 0.20 MelCos) plus
  0.25 x commitment and 1.0 x codebook loss over the books, with quantizer
  dropout (each example trains through a random number of books: full
  depth with probability 1/2, else uniform over 1..n) and the backbone
  RVQ's EMA usage tracking with dead-code reseeding after every update;
- GAN (``gan=GanConfig(...)``): the same reconstruction terms plus
  ``w_adv`` x hinge adversarial and ``w_fm`` x feature matching against MPD
  and MS-STFT discriminators (``losses/gan.py``), which get their own AdamW
  (constant ``disc_lr``, optax's default weight decay 1e-4); epochs before
  ``gan.start_epoch`` train the reconstruction alone and leave the
  discriminators as they are. A GAN step updates the discriminators on the
  fake of the generator forward it took its own update from.

The generator's optimizer is AdamW over every backbone leaf, books
included, with the global-norm clip and the skip of a non-finite update
(``train/loop.py::AdamW``), on a per-step linear warm-up and cosine decay.
A train step runs the plain residual-unit stacks with autograd
(``Encoder.forward_train``, ``Decoder.forward_train``: no kernel); the eval
step runs under ``no_grad`` through the serving encoder and decoder, on the
card through K1. Everything runs in true fp32 (``fp32_exact``), as the JAX
package trains at ``precision="highest"``.

The per-step draws (quantizer dropout, reseeds) come from ``core/rng.py``
generators, which cannot reproduce the JAX package's threefry bits.

``mesh=`` (``parallel/mesh.py``) is data parallelism as in
``train/loop.py::train_codec``: each rank runs its rows of the global
batch; the generator's and the discriminators' gradients are all-reduced
before their optimizers; the quantizer-dropout depths are the global
batch's draw (``core/rng.py::BatchShard``), and the quantizer's and the
feature-matching losses divide the global batch's means
(``parallel/mesh.py::batch_mean``); the usage tracking and the reseeds run
on every rank over the all-gathered latents, so the books stay replicated;
the metrics are the global batch's. Rank 0 alone writes the files.
"""

from __future__ import annotations

import math
import os
import time
from typing import Callable, Iterable, Optional

import numpy as np
import torch

from ..convert import dac_tree, disc_tree, load_dac_checkpoint, load_disc
from ..core import rng
from ..core.config import DacConfig, GanConfig, TrainConfig
from ..core.precision import deterministic_steps, fp32_exact
from ..data import wire
from ..eval.serving import resolve_device
from ..losses import gan as gan_mod
from ..losses.losses import codec_loss
from ..models.dac import DAC, init_dac_, quantizer_dead_code_reinit
from ..ops import rvq
from ..parallel import mesh as pmesh
from ..utils import artifacts
from . import checkpoint as ckpt
from .loop import AdamW

REINIT_TAG = 1 << 20        # the reseed generator of step s is (seed, s + 2^20)


def warmup_cosine_lr(base_lr: float, total_steps: int, warmup_steps: int,
                     min_frac: float) -> Callable:
    """Per-step schedule over an optimizer count (a tensor or an int), in
    fp32: linear warm-up ``base_lr * (step + 1) / warmup_steps``, then cosine
    decay to ``min_frac * base_lr`` at ``total_steps``. The cosine itself is
    taken in fp64 and rounded to fp32, which gives XLA's fp32 cosine where
    PyTorch's is one ulp off."""
    eta = base_lr * min_frac

    def schedule(step):
        step = torch.as_tensor(step)
        warm = (step + 1).float() * base_lr / max(1, warmup_steps)
        frac = torch.clamp((step - warmup_steps).float() / max(1, total_steps - warmup_steps),
                           0.0, 1.0)
        cosine = torch.cos((math.pi * frac).double()).float()
        cos = eta + 0.5 * (base_lr - eta) * (1.0 + cosine)
        return torch.where(step < warmup_steps, warm, cos)

    return schedule


def sample_nq_dropout(gen: torch.Generator, batch: int, n_books: int,
                      p_full: float = 0.5) -> torch.Tensor:
    """Quantizer-dropout depths [B] (int64, on ``gen``'s device): ``n_books``
    with probability ``p_full``, else uniform over 1..n_books. ``gen`` may be
    a ``core/rng.py::BatchShard``: the global batch's draw, this shard's rows."""
    full = rng.rand((batch,), gen, gen.device) < p_full
    uni = rng.randint(1, n_books + 1, (batch,), gen, gen.device)
    return torch.where(full, torch.full_like(uni, n_books), uni)


class PretrainState:
    """The backbone, its optimizer and the step count that seeds the per-step
    generators; for the reconstruction recipe the EMA usage counts [n, K]
    (None switches the reseeding off), for the GAN recipe the
    discriminators and their optimizer."""

    def __init__(self, m: DAC, opt: AdamW, step: int = 0,
                 vq_counts: Optional[torch.Tensor] = None,
                 d: Optional[gan_mod.Discriminators] = None, d_opt: Optional[AdamW] = None):
        self.m, self.opt, self.step, self.vq_counts = m, opt, step, vq_counts
        self.d, self.d_opt = d, d_opt


def generator_optimizer(m: DAC, tcfg: TrainConfig, schedule: Callable,
                        sched_offset_steps: int = 0) -> AdamW:
    """AdamW over every backbone leaf at ``schedule``, ``tcfg``'s betas,
    clip and weight decay."""
    return AdamW(list(m.parameters()), tcfg, sched_offset_steps=sched_offset_steps,
                 betas=(tcfg.adam_b1, tcfg.adam_b2), schedule=schedule)


def disc_optimizer(d: gan_mod.Discriminators, tcfg: TrainConfig, gcfg: GanConfig) -> AdamW:
    """The discriminators' AdamW: constant ``disc_lr``, their betas,
    ``tcfg``'s clip, and weight decay 1e-4 (optax's ``adamw`` default, which
    the JAX package leaves in place)."""
    lr = gcfg.disc_lr
    return AdamW(list(d.parameters()), tcfg, betas=(gcfg.disc_b1, gcfg.disc_b2),
                 schedule=lambda step: lr, weight_decay=1e-4)


def _update(opt: AdamW, loss: torch.Tensor, mesh: Optional[pmesh.Mesh] = None) -> None:
    """One update of ``opt``'s leaves from the gradient of ``loss`` toward
    them alone (left in their ``.grad``, the mean over the batch shards with
    ``mesh``); no other leaf gets a gradient."""
    grads = torch.autograd.grad(loss, opt.params, allow_unused=True)
    for p, g in zip(opt.params, grads):
        p.grad = g
    pmesh.reduce_grads(mesh, opt.params)
    opt.step()


def _recon(m: DAC, cfg: DacConfig, x: torch.Tensor, nq: Optional[torch.Tensor],
           w_commit: float, w_codebook: float, train: bool) -> dict:
    """The backbone on x [B, 1, T]: the training encode and decode with
    autograd (``train``), else the serving ones, and the reconstruction
    total with the VQ terms."""
    n = cfg.n_codebooks
    z = m.encoder.forward_train(x, cfg) if train else m.encoder(x, cfg)
    zq, codes, commit, codebk = m.quantizer.quantize_train(z, nq)
    y = m.decoder.forward_train(zq, cfg) if train else m.decoder(zq, cfg)
    T = min(y.shape[-1], x.shape[-1])
    y, x = y[..., :T], x[..., :T]
    total, parts = codec_loss(y, x, sr=cfg.sample_rate)
    total = total + w_commit * commit / n + w_codebook * codebk / n
    return {"y": y, "x": x, "total": total, "parts": parts, "z": z.detach(), "codes": codes}


def _nq(base_seed: Optional[int], step: int, batch: int, n_books: int, dev,
        mesh: Optional[pmesh.Mesh] = None) -> Optional[torch.Tensor]:
    if base_seed is None:
        return None
    gen = rng.generator(base_seed, step, device=dev)
    if mesh is not None:
        gen = rng.BatchShard(gen, mesh.batch_index, mesh.batch_shards)
    return sample_nq_dropout(gen, batch, n_books)


def _global(mesh: Optional[pmesh.Mesh], metrics: torch.Tensor) -> torch.Tensor:
    """A metric vector of this rank's rows as the global batch's mean."""
    return metrics if mesh is None else pmesh.all_reduce_mean(mesh, metrics)


def _eval_fn(cfg: DacConfig, w_commit: float, w_codebook: float,
             mesh: Optional[pmesh.Mesh] = None) -> Callable:
    @torch.no_grad()
    @deterministic_steps()
    def eval_step(m: DAC, x: torch.Tensor) -> torch.Tensor:
        """The reconstruction total on x, through the serving encoder and
        decoder (K1 on the card)."""
        with pmesh.batch_scope(mesh):
            out = _recon(m, cfg, wire.decode_wave(x), None, w_commit, w_codebook, False)
        return _global(mesh, out["total"])
    return eval_step


def make_pretrain_step(cfg: DacConfig, tcfg: TrainConfig, w_commit: float = 0.25,
                       w_codebook: float = 1.0, mesh: Optional[pmesh.Mesh] = None):
    """-> (pretrain_step(state, x, base_seed=None) -> [total, bits],
    eval_step(m, x) -> total), tensors on the device. ``base_seed`` None:
    every example through every book, and the reseeds drawn from seed 0;
    else the dropout of step s from ``(base_seed, s)`` and the reseeds from
    ``(base_seed, s + 2^20)``. ``bits`` is the mean measured entropy of the
    step's codes per book. With ``mesh`` x is this rank's rows, and the
    numbers the global batch's."""
    n_books = cfg.n_codebooks

    def gathered(t: torch.Tensor) -> torch.Tensor:
        return t if mesh is None else pmesh.all_gather_batch(mesh, t)

    @deterministic_steps()
    def pretrain_step(state: PretrainState, x: torch.Tensor,
                      base_seed: Optional[int] = None) -> torch.Tensor:
        x = wire.decode_wave(x)
        dev = x.device
        with pmesh.batch_scope(mesh):
            out = _recon(state.m, cfg, x,
                         _nq(base_seed, state.step, x.shape[0], n_books, dev, mesh),
                         w_commit, w_codebook, True)
            _update(state.opt, out["total"], mesh)
        if state.vq_counts is not None:
            gen = (rng.generator(base_seed, state.step + REINIT_TAG, device=dev)
                   if base_seed is not None else torch.Generator(device=dev).manual_seed(0))
            books, state.vq_counts = quantizer_dead_code_reinit(
                state.m.quantizer, state.vq_counts, gathered(out["z"]), gen)
            with torch.no_grad():
                state.m.quantizer.codebooks.copy_(books)
        bits = rvq.usage_stats(gathered(out["codes"]), cfg.codebook_size)["bits"].mean()
        state.step += 1
        return torch.stack([_global(mesh, out["total"].detach()), bits])

    return pretrain_step, _eval_fn(cfg, w_commit, w_codebook, mesh)


def make_gan_pretrain_step(cfg: DacConfig, tcfg: TrainConfig, gcfg: GanConfig,
                           w_commit: float = 0.25, w_codebook: float = 1.0,
                           mesh: Optional[pmesh.Mesh] = None):
    """-> (gan_step, warmup_step, eval_step). ``gan_step(state, x,
    base_seed=None)`` and ``warmup_step`` -> [total, d_val, adv, fm] (zeros
    but the total in a warm-up step, which leaves the discriminators as they
    are, and whose total is ``codec_loss``'s alone, as the JAX package
    reports it); ``eval_step(m, x)`` -> the reconstruction total. The generator's
    total adds ``w_adv * adv + w_fm * fm``; its gradient is taken toward
    the backbone's leaves alone, and the discriminators then step on the
    same forward's (detached) fake against the real batch. With ``mesh`` x
    is this rank's rows, and the numbers the global batch's."""
    n_books = cfg.n_codebooks

    @deterministic_steps()
    def gan_step(state: PretrainState, x: torch.Tensor,
                 base_seed: Optional[int] = None) -> torch.Tensor:
        x = wire.decode_wave(x)
        with pmesh.batch_scope(mesh):
            out = _recon(state.m, cfg, x, _nq(base_seed, state.step, x.shape[0], n_books,
                                              x.device, mesh), w_commit, w_codebook, True)
            adv, fm = gan_mod.gan_losses(state.d, gcfg, out["x"], out["y"])
            total = out["total"] + gcfg.w_adv * adv + gcfg.w_fm * fm
            _update(state.opt, total, mesh)
        y = out["y"].detach()
        real_logits, _ = gan_mod.disc_apply(state.d, gcfg, out["x"])
        fake_logits, _ = gan_mod.disc_apply(state.d, gcfg, y)
        d_val = gan_mod.disc_loss(real_logits, fake_logits, gcfg.loss_kind)
        _update(state.d_opt, d_val, mesh)
        state.step += 1
        return _global(mesh, torch.stack([total.detach(), d_val.detach(), adv.detach(),
                                          fm.detach()]))

    @deterministic_steps()
    def warmup_step(state: PretrainState, x: torch.Tensor,
                    base_seed: Optional[int] = None) -> torch.Tensor:
        x = wire.decode_wave(x)
        with pmesh.batch_scope(mesh):
            out = _recon(state.m, cfg, x, _nq(base_seed, state.step, x.shape[0], n_books,
                                              x.device, mesh), w_commit, w_codebook, True)
            _update(state.opt, out["total"], mesh)
        state.step += 1
        # the JAX package reports the reconstruction loss here without the
        # VQ terms it trains on (its warm-up returns codec_loss's total)
        rec = out["parts"]["total"].detach()
        zero = rec.new_zeros(())
        return _global(mesh, torch.stack([rec, zero, zero, zero]))

    return gan_step, warmup_step, _eval_fn(cfg, w_commit, w_codebook, mesh)


def pretrain_backbone(
    cfg: DacConfig,
    tcfg: TrainConfig,
    train_batches: Callable[[int], Iterable],
    val_batches: Callable[[], Iterable],
    out_dir: str,
    seed: int = 7,
    mesh=None,
    steps_per_epoch: Optional[int] = None,
    save_every: int = 1,
    gan: Optional[GanConfig] = None,
    nq_dropout: bool = True,
    warmup_steps: Optional[int] = None,
    resume_from: Optional[str] = None,
    start_epoch: Optional[int] = None,
    log: Callable[[str], None] = print,
    on_epoch: Optional[Callable[[int, PretrainState], None]] = None,
    device=None,
) -> dict:
    """Train one backbone on waveform batches [B, 1, T] (numpy float, or
    int16 wire batches) on the device (the card unless ``device="cpu"``);
    -> hist ``{"train": [...], "val": [...]}``.

    The JAX package's loop: ``last.msgpack`` every ``save_every`` epochs and
    at the last (with ``vq_counts.msgpack`` in the reconstruction recipe,
    ``disc_last.msgpack`` in the GAN one), ``best.msgpack`` on a validation
    improvement at most every ``save_every`` epochs and at the end, and
    ``hist.json``, all written by ``AsyncCheckpointer``. ``resume_from``
    loads a backbone checkpoint strictly and starts at ``start_epoch`` (its
    epoch + 1 when None) with fresh moments and the schedule at its place;
    the usage counts come from ``vq_counts.msgpack`` beside it (100 each
    where it is absent, so the reseeding waits for the EMA to fall), the
    discriminators from ``disc_last.msgpack``. A train loss above 5x the
    best validation loss after ``tcfg.best_after_epoch`` restores the best
    backbone (and discriminators) with their moments zeroed; 30 epochs of
    code usage under 0.35 x log2(K) bits zero the generator's moments.
    ``on_epoch(ep, state)`` is called at the end of each epoch. ``mesh``:
    data parallelism (the module's docstring; the device is then the
    mesh's), made by ``parallel/mesh.py::mesh_for_batch`` when None; rank 0
    alone writes the files."""
    if mesh is None:
        mesh = pmesh.mesh_for_batch(tcfg.batch)
    else:
        mesh.shard_size(tcfg.batch)          # raises where the batch does not divide
    dev = mesh.device if mesh is not None else resolve_device(device)
    writer = mesh is None or mesh.rank == 0
    os.makedirs(out_dir, exist_ok=True)
    m = init_dac_(DAC(cfg), torch.Generator().manual_seed(seed))
    if resume_from is not None:
        ck_epoch, _ = load_dac_checkpoint(m, resume_from)
        if start_epoch is None:
            start_epoch = ck_epoch + 1
        log(f"[pretrain] resuming from {resume_from} (epoch {ck_epoch}) at epoch {start_epoch}")
    start_epoch = start_epoch or 1
    if steps_per_epoch is None:
        steps_per_epoch = max(1, sum(1 for _ in train_batches(0)))
    m = m.to(dev)
    if mesh is not None:
        pmesh.shard_replicated(mesh, m)

    total_steps = tcfg.epochs * steps_per_epoch
    if warmup_steps is None:
        warmup_steps = min(500, max(50, total_steps // 20))
    schedule = warmup_cosine_lr(tcfg.lr, total_steps, warmup_steps, tcfg.lr_min_frac)
    # the resumed optimizer's count starts at 0: shift the schedule to its place
    sched_off = (start_epoch - 1) * steps_per_epoch
    opt = generator_optimizer(m, tcfg, schedule, sched_off)
    base_seed = seed + 2 if nq_dropout else None

    if gan is not None:
        d = gan_mod.disc_init(gan, torch.Generator().manual_seed(seed + 1))
        if resume_from is not None:
            d_path = os.path.join(os.path.dirname(resume_from), "disc_last.msgpack")
            if os.path.exists(d_path):
                d = load_disc(d_path, gan)
                log(f"[pretrain] resumed discriminator from {d_path}")
        d = d.to(dev)
        if mesh is not None:
            pmesh.shard_replicated(mesh, d)
        state = PretrainState(m, opt, d=d, d_opt=disc_optimizer(d, tcfg, gan))
        gan_fn, warmup_fn, eval_fn = make_gan_pretrain_step(cfg, tcfg, gan, mesh=mesh)

        def step_fn(ep: int):
            fn = gan_fn if ep >= gan.start_epoch else warmup_fn
            return lambda st, x: fn(st, x, base_seed)[:1]
    else:
        counts0 = torch.zeros(cfg.n_codebooks, cfg.codebook_size)
        if resume_from is not None:
            # all-zero counts would adopt the first batch's and reseed every
            # trained code it misses
            c_path = os.path.join(os.path.dirname(resume_from), "vq_counts.msgpack")
            if os.path.exists(c_path):
                counts0 = torch.from_numpy(ckpt.load_vq_counts(c_path, tuple(counts0.shape)))
                log(f"[pretrain] resumed VQ usage tracker from {c_path}")
            else:
                counts0 = counts0 + 100.0
        state = PretrainState(m, opt, vq_counts=counts0.to(dev))
        base_step, eval_fn = make_pretrain_step(cfg, tcfg, mesh=mesh)

        def step_fn(ep: int):
            return lambda st, x: base_step(st, x, base_seed)

    def put(b) -> torch.Tensor:
        return torch.as_tensor(b).to(dev) if mesh is None else pmesh.shard_batch(mesh, b)

    best_val, best_epoch, best_saved_ep = float("inf"), 0, 0
    best_m = best_d = None          # device copies until the final write
    hist = {"train": [], "val": []}
    # VQ-stall restart: codes stuck near 1-2 of log2(K) bits for 30 epochs
    stall_window = 30
    stall_bits = 0.35 * float(np.log2(cfg.codebook_size))
    bits_hist: list = []
    last_reset_ep = 0
    acp = ckpt.AsyncCheckpointer()
    save = acp.save if writer else (lambda *args: None)
    try:
        with fp32_exact(dev.type == "cuda"):
            for ep in range(start_epoch, tcfg.epochs + 1):
                t0 = time.time()
                fn = step_fn(ep)
                parts = [fn(state, put(x)) for x in train_batches(ep)]
                vals = [eval_fn(state.m, put(x)) for x in val_batches()]
                tr_vec = torch.stack(parts).mean(0) if parts else torch.zeros(1, device=dev)
                va = torch.stack(vals).mean() if vals else torch.zeros((), device=dev)
                # one device-to-host copy an epoch: [total(, bits), val]
                packed = torch.cat([tr_vec, va[None]]).cpu().numpy()
                hist["train"].append(float(packed[0]))
                v = float(packed[-1])
                hist["val"].append(v)
                bits_s = f" | VQ {packed[1]:.2f}b" if packed.shape[0] > 2 else ""
                log(f"[pretrain] epoch {ep:03d} | train {hist['train'][-1]:.4f} | "
                    f"val {v:.4f}{bits_s} | {time.time() - t0:.1f}s")

                # divergence recovery: the finite gate stops NaN/Inf, not a
                # finite blow-up; 5x leaves room for the GAN terms
                if (best_m is not None and np.isfinite(hist["train"][-1])
                        and hist["train"][-1] > 5.0 * max(best_val, 1e-9)
                        and ep > tcfg.best_after_epoch):
                    log(f"[pretrain] divergence at epoch {ep} (train "
                        f"{hist['train'][-1]:.3f} vs best val {best_val:.3f}): "
                        f"restoring best (epoch {best_epoch}), resetting optimizer")
                    state.m.load_state_dict(best_m.state_dict())
                    state.opt.reset_moments()
                    if best_d is not None:
                        state.d.load_state_dict(best_d.state_dict())
                        state.d_opt.reset_moments()

                if packed.shape[0] > 2:
                    bits_hist.append(float(packed[1]))
                    window = bits_hist[-stall_window:]
                    if (len(window) >= stall_window and max(window) < stall_bits
                            and ep - last_reset_ep >= stall_window):
                        log(f"[pretrain] VQ stall (bits < {stall_bits:.1f} for "
                            f"{stall_window} epochs): resetting optimizer moments")
                        state.opt.reset_moments()
                        last_reset_ep = ep

                if ep % save_every == 0 or ep == tcfg.epochs:
                    save(os.path.join(out_dir, "last.msgpack"), dac_tree(state.m), ep, hist)
                    if state.vq_counts is not None:
                        save(os.path.join(out_dir, "vq_counts.msgpack"), state.vq_counts, ep,
                             {})
                    if state.d is not None:
                        save(os.path.join(out_dir, "disc_last.msgpack"), disc_tree(state.d),
                             ep, {})
                if v < best_val:
                    best_val, best_epoch = v, ep
                    if best_m is None:
                        best_m = DAC(cfg).to(dev).requires_grad_(False)
                        if state.d is not None:
                            best_d = gan_mod.Discriminators(gan).to(dev).requires_grad_(False)
                    best_m.load_state_dict(state.m.state_dict())
                    if best_d is not None:
                        best_d.load_state_dict(state.d.state_dict())
                    if ep - best_saved_ep >= save_every:
                        save(os.path.join(out_dir, "best.msgpack"), dac_tree(best_m),
                             best_epoch, hist)
                        best_saved_ep = ep
                if on_epoch is not None:
                    on_epoch(ep, state)

        if best_m is not None:
            save(os.path.join(out_dir, "best.msgpack"), dac_tree(best_m), best_epoch, hist)
    finally:
        acp.close()
    if writer:
        artifacts.write_hist(out_dir, hist)
    return hist
