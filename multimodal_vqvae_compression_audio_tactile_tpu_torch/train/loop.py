"""Training loop of the codec head (AllPredAR) against frozen backbones.

The JAX package's ``train/loop.py`` on its generator path: AdamW (lr 2e-4,
decoupled weight decay 1e-5, b1 0.9, b2 0.999, eps 1e-8) over every head
parameter but the VQ books, global-norm clip 3.0 first, per-epoch cosine
anneal to 0.1 lr, loss 0.55 L1 + 0.25 MR-STFT + 0.20 MelCos, an update
skipped whole when a gradient is not finite, the EMA codebook step after
``ema_warm_epochs``, ``last``/``best`` checkpoints and ``hist.json``.

Where a PyTorch loop most easily drifts from the optax chain, this one
follows optax:

- the books (and their EMA counts) are neither AdamW parameters nor part of
  the clip's global norm;
- the clip scales by ``max / norm`` only when ``norm >= max``
  (``optax.clip_by_global_norm``; ``clip_grad_norm_`` would divide by
  ``norm + 1e-6``);
- a non-finite gradient leaves the head, the moments, the step count and
  the schedule's count as they were (``optax.apply_if_finite``), decided on
  the device; the EMA step still runs;
- the learning rate follows the optimizer's own count (shifted on resume),
  while ``TrainState.step`` only seeds the per-step dropout and reinit
  generators;
- the EMA step uses the books the forward saw, after the update.

On the card the encoders run under ``no_grad`` through K1 (48 launches a
step in fp32) and the tactile decoder through its plain stacks with
autograd; everything runs in true fp32 (``fp32_exact``), as the JAX
package trains at ``precision="highest"``. The cached-latent path
(``train/latent_cache.py`` there) is not ported yet.
"""

from __future__ import annotations

import math
import os
import time
from typing import Callable, Iterable, List, Optional

import numpy as np
import torch

from ..convert import head_tree, load_head_tolerant
from ..core.config import CodecConfig, TrainConfig
from ..core.precision import fp32_exact
from ..data import wire
from ..eval.serving import resolve_device
from ..losses.losses import codec_loss
from ..models import allpred_ar
from ..models.allpred_ar import CodecModules, Head
from ..models.dac import DAC
from ..ops import rvq
from ..utils import artifacts
from . import checkpoint as ckpt

METRIC_KEYS = ("total", "l1", "stft", "mel", "vq_bits", "vq_bits_min", "vq_used")
ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
_DROPOUT_SALT, _REINIT_SALT = 0, 0x5EED


def cosine_epoch_lr(base_lr: float, epochs: int, min_frac: float,
                    steps_per_epoch: int) -> Callable:
    """Per-epoch cosine anneal over an optimizer count (a tensor or an int):
    epoch e of training uses the rate of epoch e - 1 of
    ``CosineAnnealingLR``, from ``base_lr`` to ``min_frac * base_lr``."""
    eta_min = base_lr * min_frac

    def schedule(step):
        step = torch.as_tensor(step)
        epoch = torch.clamp(step // max(1, steps_per_epoch), max=epochs).float()
        return eta_min + 0.5 * (base_lr - eta_min) * (1.0 + torch.cos(math.pi * epoch / epochs))

    return schedule


def adamw_params(head: Head) -> List[torch.nn.Parameter]:
    """The head's AdamW leaves: every parameter but the VQ books (the EMA
    counts are a buffer)."""
    return [p for name, p in head.named_parameters() if name != "vq_books"]


class AdamW:
    """``optax.apply_if_finite(optax.masked(optax.chain(
    clip_by_global_norm(clip), adamw(schedule, weight_decay=wd))))`` over
    ``params``, all of it on the device: no host sync a step."""

    def __init__(self, params: List[torch.nn.Parameter], tcfg: TrainConfig,
                 steps_per_epoch: int, sched_offset_steps: int = 0):
        self.params = list(params)
        self.clip, self.wd = tcfg.grad_clip, tcfg.weight_decay
        self.schedule = cosine_epoch_lr(tcfg.lr, tcfg.epochs, tcfg.lr_min_frac,
                                        steps_per_epoch)
        self.offset = sched_offset_steps
        dev = self.params[0].device
        self.count = torch.zeros((), dtype=torch.int64, device=dev)
        self.mu = [torch.zeros_like(p) for p in self.params]
        self.nu = [torch.zeros_like(p) for p in self.params]

    def lr(self) -> torch.Tensor:
        return self.schedule(self.count + self.offset)

    @torch.no_grad()
    def step(self) -> torch.Tensor:
        """Apply one update from the parameters' ``.grad`` (None counts as
        zero); -> whether it was applied (a bool tensor: every gradient
        finite)."""
        grads = [torch.zeros_like(p) if p.grad is None else p.grad for p in self.params]
        finite = torch.stack([torch.isfinite(g).all() for g in grads]).all()
        norm = torch.sqrt(sum(torch.sum(g * g) for g in grads))
        grads = [torch.where(norm < self.clip, g, g / norm * self.clip) for g in grads]
        count = self.count + 1
        bc1 = 1.0 - ADAM_B1 ** count.float()
        bc2 = 1.0 - ADAM_B2 ** count.float()
        lr = self.lr()
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            mu_new = (1.0 - ADAM_B1) * g + ADAM_B1 * mu
            nu_new = (1.0 - ADAM_B2) * g * g + ADAM_B2 * nu
            u = (mu_new / bc1) / (torch.sqrt(nu_new / bc2) + ADAM_EPS) + self.wd * p
            p.copy_(torch.where(finite, p - lr * u, p))
            mu.copy_(torch.where(finite, mu_new, mu))
            nu.copy_(torch.where(finite, nu_new, nu))
        self.count = torch.where(finite, count, self.count)
        return finite


class TrainState:
    """The codec (frozen backbones + the trained head), its optimizer and the
    step count that seeds the per-step generators."""

    def __init__(self, m: CodecModules, opt: AdamW, step: int = 0):
        self.m, self.opt, self.step = m, opt, step

    @property
    def head(self) -> Head:
        return self.m.head


def step_generator(seed: int, step: int, salt: int, device) -> torch.Generator:
    """The generator of one step's random draws (dropout: salt 0; dead-code
    reinit: 0x5EED), on ``device``."""
    g = torch.Generator(device=device)
    g.manual_seed((seed * 0x9E3779B1 + step * 0x85EBCA77 + salt) % (1 << 63))
    return g


def make_step_fns(cfg: CodecConfig, tcfg: TrainConfig):
    """-> (train_step(state, a, tc, base_seed, do_ema) -> metrics,
    eval_step(m, a, tc) -> metrics); metrics is one [len(METRIC_KEYS)]
    tensor on the device. ``base_seed`` None: no dropout, reinit draws from
    seed 0."""

    def loss_fn(m: CodecModules, a, tc, gen):
        a, tc = wire.decode_wave(a), wire.decode_wave(tc)
        out = allpred_ar.forward_step(m, a, tc, dropout=gen, cfg=cfg)
        total, parts = codec_loss(out["y_hat"], out["tgt"], w_wav_l1=tcfg.loss.w_wav_l1,
                                  w_stft=tcfg.loss.w_stft, w_melcos=tcfg.loss.w_melcos,
                                  sr=tcfg.target_sr)
        return total, parts, out

    def pack_metrics(parts: dict, codes, valid) -> torch.Tensor:
        stats = rvq.usage_stats(codes, cfg.rvq.n_embed, valid=valid)
        parts = dict(parts, vq_bits=stats["bits"].mean(), vq_bits_min=stats["bits"].min(),
                     vq_used=stats["used_frac"].mean())
        return torch.stack([parts[k].detach().float() for k in METRIC_KEYS])

    def train_step(state: TrainState, a, tc, base_seed: Optional[int],
                   do_ema: bool = False) -> torch.Tensor:
        head, dev = state.head, a.device
        gen = None if base_seed is None else step_generator(base_seed, state.step,
                                                            _DROPOUT_SALT, dev)
        head.zero_grad(set_to_none=True)
        total, parts, out = loss_fn(state.m, a, tc, gen)
        total.backward()
        state.opt.step()
        if do_ema:
            reinit = (step_generator(base_seed, state.step, _REINIT_SALT, dev)
                      if base_seed is not None else torch.Generator(device=dev).manual_seed(0))
            valid_bt = torch.broadcast_to(out["valid"][None], out["r_tokens"].shape[::2])
            books, counts = rvq.ema_update_with_reinit(
                head.vq_books, head.vq_counts, out["r_tokens"], reinit, valid=valid_bt,
                decay=cfg.rvq.ema_decay, ema_mode=cfg.rvq.ema_mode, dead_frac=cfg.rvq.dead_frac)
            with torch.no_grad():
                head.vq_books.copy_(books)
                head.vq_counts.copy_(counts)
        state.step += 1
        return pack_metrics(parts, out["codes"], out["valid"])

    @torch.no_grad()
    def eval_step(m: CodecModules, a, tc) -> torch.Tensor:
        _, parts, out = loss_fn(m, a, tc, None)
        return pack_metrics(parts, out["codes"], out["valid"])

    return train_step, eval_step


def _frozen(bb: DAC, dev: torch.device) -> DAC:
    return bb.to(dev).requires_grad_(False)


def train_codec(cfg: CodecConfig, tcfg: TrainConfig, backbones: dict,
                train_batches: Callable[[int], Iterable],
                val_batches: Callable[[], Iterable], out_dir: str, seed: int = 7,
                steps_per_epoch: Optional[int] = None, save_every: int = 1,
                resume: bool = False, cache=None, log: Callable[[str], None] = print,
                on_epoch: Optional[Callable[[int, Head], None]] = None,
                device=None) -> dict:
    """Train the head with the reference's artifact contract; -> hist.

    backbones: {"audio": DAC, "tactile": DAC}, frozen here and moved to the
    device (the card unless ``device="cpu"``). ``train_batches(epoch)`` and
    ``val_batches()`` yield (a, tc) numpy batches [B, 1, T] (float, or int16
    wire batches). Writes ``last.msgpack`` every ``save_every`` epochs and
    at the end, ``best.msgpack`` (the best validation loss after
    ``tcfg.best_after_epoch``) at the end, and ``hist.json``; the loss
    curves' ``curves.png`` is not written (no matplotlib). ``on_epoch(ep,
    head)`` is called after each epoch's bookkeeping."""
    if cache is not None:
        raise NotImplementedError(
            "the cached-latent training path (train/latent_cache.py) is not ported "
            "yet: ROADMAP.md, Queue 1 item 9")
    dev = resolve_device(device)
    os.makedirs(out_dir, exist_ok=True)
    head = allpred_ar.head_init(cfg, torch.Generator().manual_seed(seed))

    start_epoch = 1
    resumed_hist = None
    last_path = os.path.join(out_dir, "last.msgpack")
    if resume and os.path.exists(last_path):
        last_epoch, resumed_hist = load_head_tolerant(head, last_path)
        start_epoch = last_epoch + 1
        log(f"[resume] from {last_path} at epoch {last_epoch}")
        if not bool(head.vq_counts.any()):
            # a checkpoint from before vq_counts: all-zero counts would make
            # the first EMA step adopt one batch's counts and reseed every
            # code it misses; warm-start high instead
            with torch.no_grad():
                head.vq_counts.add_(100.0)
            log("[resume] pre-schema checkpoint: warm-started vq_counts=100")

    if steps_per_epoch is None:
        steps_per_epoch = max(1, sum(1 for _ in train_batches(0)))
    head = head.to(dev)
    m = allpred_ar.codec_of(_frozen(backbones["audio"], dev),
                            _frozen(backbones["tactile"], dev), head, cfg)
    offset = (start_epoch - 1) * steps_per_epoch

    def fresh_optimizer() -> AdamW:
        return AdamW(adamw_params(head), tcfg, steps_per_epoch, sched_offset_steps=offset)

    state = TrainState(m, fresh_optimizer())
    train_step, eval_step = make_step_fns(cfg, tcfg)

    def put(b):
        return tuple(torch.from_numpy(np.asarray(x)).to(dev) for x in b)

    best_val = float("inf")
    best_head = None          # a device copy until the final write
    best_epoch = 0
    hist = {"train": [], "val": [], "l1": [], "stft": [], "mel": [], "ema": [],
            "vq_bits": [], "vq_bits_min": [], "vq_used": []}
    if resumed_hist:
        hist.update({k: list(v) for k, v in resumed_hist.items()})
        # pad series a pre-schema hist lacks with NaN: every list stays
        # epoch-aligned
        n_ep = len(hist["train"])
        for k, v in hist.items():
            if len(v) < n_ep:
                hist[k] = [float("nan")] * (n_ep - len(v)) + list(v)
        if hist["val"]:
            best_val = min(hist["val"])
        state.step = offset

    base_seed = seed + 1
    acp = ckpt.AsyncCheckpointer()
    nm = len(METRIC_KEYS)
    try:
        with fp32_exact(dev.type == "cuda"):
            for ep in range(start_epoch, tcfg.epochs + 1):
                t0 = time.time()
                do_ema = ep > cfg.rvq.ema_warm_epochs
                step_metrics = [train_step(state, *put(b), base_seed, do_ema=do_ema)
                                for b in train_batches(ep)]
                val_metrics = [eval_step(m, *put(b)) for b in val_batches()]
                # one device-to-host copy an epoch
                packed = torch.stack([
                    torch.stack(step_metrics).mean(0) if step_metrics
                    else torch.zeros(nm, device=dev),
                    torch.stack(val_metrics).mean(0) if val_metrics
                    else torch.zeros(nm, device=dev)]).cpu().numpy()
                sums = dict(zip(METRIC_KEYS, packed[0].tolist()))
                for k in ("l1", "stft", "mel", "vq_bits", "vq_bits_min", "vq_used"):
                    hist[k].append(sums[k])
                hist["train"].append(sums["total"])
                hist["ema"].append(1.0 if do_ema else 0.0)
                v = float(packed[1][0])
                hist["val"].append(v)
                log(f"Epoch {ep:03d} | train {hist['train'][-1]:.4f} | val {v:.4f}"
                    f" | L1 {hist['l1'][-1]:.4f} | STFT {hist['stft'][-1]:.4f} | "
                    f"MEL {hist['mel'][-1]:.4f} | VQ {sums['vq_bits']:.2f}b"
                    f"(min {sums['vq_bits_min']:.2f}, used {sums['vq_used']:.2f})"
                    f" | {time.time() - t0:.1f}s")

                # divergence recovery: the finite gate stops NaN/Inf, not a
                # finite blow-up
                if (best_head is not None and np.isfinite(hist["train"][-1])
                        and hist["train"][-1] > 5.0 * max(best_val, 1e-9)):
                    log(f"divergence at epoch {ep} (train {hist['train'][-1]:.3f} vs best "
                        f"val {best_val:.3f}): restoring best (epoch {best_epoch}), "
                        "resetting optimizer")
                    with torch.no_grad():
                        for p, b in zip(head.state_dict().values(), best_head.values()):
                            p.copy_(b)
                    state.opt = fresh_optimizer()

                if ep % save_every == 0 or ep == tcfg.epochs:
                    acp.save(last_path, head_tree(head), ep, hist)
                if v + 1e-6 < best_val and ep > tcfg.best_after_epoch:
                    best_val, best_epoch = v, ep
                    best_head = {k: t.detach().clone() for k, t in head.state_dict().items()}
                    log("new best")
                if on_epoch is not None:
                    on_epoch(ep, head)

        if best_head is not None:
            best = Head(cfg).to(dev)
            best.load_state_dict(best_head)
            acp.save(os.path.join(out_dir, "best.msgpack"), head_tree(best), best_epoch, hist)
    finally:
        acp.close()
    artifacts.write_hist(out_dir, hist)
    log("curves.png not written: the loss curves need matplotlib "
        "(ROADMAP.md, Queue 1 item 7)")
    return hist
