"""Time one step of each trainer on one CUDA card, and check that the step
is reproducible.

    python3 multimodal_vqvae_compression_audio_tactile_tpu_torch/scripts/time_train_steps.py \\
        [--case head ...] [--tag NAME] [--reps 5] [--kernels N]

One JSON line a step, at full width with random weights made from fixed
seeds, fp32 with TF32 off (``CASES``): the head step on waveforms and on
cached latents (``CodecConfig().with_rvq(10, 128)``, batch 6, 1 s, with the
EMA and reseeding), the PLC step, its decoder-free latent step and the
decoder fine-tune (batch 4), the reconstruction pretraining step with its
reseeding and the GAN step (``DacConfig()``, ``GanConfig()``, batch 4). Each
line holds the step's time by CUDA events (mean of ``--reps`` steps after
two warm-ups, the state carried from step to step), its device time (the
sum of torch.profiler's CUDA kernel times over one step; with ``--kernels
N`` the N kernels with the most of it) and whether the step run twice from
one start gives bit-equal metrics, parameters, optimizer and EMA state.
Run by path, it times the copy of the package that comes first on the
path, so setting PYTHONPATH to another checkout times that one: two
checkouts compared in one run on one card. It needs a card.
"""

from __future__ import annotations

import argparse
import copy
import json
import os
import subprocess
import sys

import numpy as np
import torch

# the checkout this file is in, after anything PYTHONPATH put first
sys.path.append(os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from multimodal_vqvae_compression_audio_tactile_tpu_torch.core.config import (  # noqa: E402
    CodecConfig, DacConfig, GanConfig, LossConfig, TrainConfig)
from multimodal_vqvae_compression_audio_tactile_tpu_torch.core.precision import fp32_exact  # noqa: E402
from multimodal_vqvae_compression_audio_tactile_tpu_torch.losses import gan  # noqa: E402
from multimodal_vqvae_compression_audio_tactile_tpu_torch.models import allpred_ar, dac  # noqa: E402
from multimodal_vqvae_compression_audio_tactile_tpu_torch.plc import masks  # noqa: E402
from multimodal_vqvae_compression_audio_tactile_tpu_torch.plc import model as plc  # noqa: E402
from multimodal_vqvae_compression_audio_tactile_tpu_torch.plc import train as plc_train  # noqa: E402
from multimodal_vqvae_compression_audio_tactile_tpu_torch.train import latent_cache as lc  # noqa: E402
from multimodal_vqvae_compression_audio_tactile_tpu_torch.train import loop  # noqa: E402
from multimodal_vqvae_compression_audio_tactile_tpu_torch.train import (  # noqa: E402
    pretrain_backbone as pb)

CFG = CodecConfig().with_rvq(10, 128)
TCFG = TrainConfig(batch=6, loss=LossConfig(w_plc_latent=1.0, w_plc_masked=0.5))
SEED = 11


def waves(dev, B: int, T: int = 24000, seed: int = 3) -> tuple:
    rng = np.random.default_rng(seed)
    a = (0.2 * rng.standard_normal((B, 1, T))).astype(np.float32)
    tc = np.clip(0.5 * a + 0.05 * rng.standard_normal((B, 1, T)), -1, 1).astype(np.float32)
    return torch.from_numpy(a).to(dev), torch.from_numpy(tc).to(dev)


def opt_state(opt: loop.AdamW) -> list:
    return list(opt.params) + list(opt.mu) + list(opt.nu) + [opt.count]


# Each case: dev -> (start, step): ``step(state)`` runs one step of the
# trainer on ``state`` in place (a deep copy of ``start``, which it leaves
# as it is) and returns the tensors the step leaves: metrics, parameters,
# optimizer state, EMA books and counts.

def head_case(dev, cached: bool) -> tuple:
    m = allpred_ar.codec_init(CFG, torch.Generator().manual_seed(1)).to(dev)
    m.audio_dac.requires_grad_(False)
    m.tactile_dac.requires_grad_(False)
    a, tc = waves(dev, TCFG.batch)
    if cached:
        cache = lc.build_latent_cache({"audio": m.audio_dac, "tactile": m.tactile_dac}, CFG,
                                      iter([(a.cpu().numpy(), tc.cpu().numpy())]), device=dev)
        a = (cache.qa, cache.zt)
    step_fn, _ = loop.make_step_fns(CFG, TCFG)

    def step(state):
        m, opt = state
        metrics = step_fn(loop.TrainState(m, opt, step=3), a, tc, SEED, do_ema=True)
        return [metrics, m.head.vq_books, m.head.vq_counts, *m.head.parameters(),
                *opt_state(opt)]
    return (m, loop.AdamW(loop.adamw_params(m.head), TCFG, 10)), step


def plc_case(dev, which: str) -> tuple:
    m = plc.plc_init(CFG, torch.Generator().manual_seed(2), n_layers=1).to(dev)
    m.requires_grad_(False)
    a, tc = waves(dev, 4)
    mask = torch.from_numpy(masks.make_token_loss_mask(np.random.default_rng(4), 4, 75, 2,
                                                       0.5)).to(dev)
    bb = {"audio": m.audio_dac, "tactile": m.tactile_dac}
    if which == "decoder_ft":
        dec = copy.deepcopy(m.tactile_dac.decoder).requires_grad_(True)
        ft_step, _ = plc_train.make_decoder_ft_step(CFG, TCFG)

        def step(state):
            dec, opt = state
            metrics = ft_step(dec, opt, m.head, bb, a, tc, mask,
                              torch.Generator(dev).manual_seed(SEED))
            return [metrics, *dec.parameters(), *opt_state(opt)]
        return (dec, loop.AdamW(list(dec.parameters()), TCFG, 10)), step
    head = m.head.requires_grad_(True)
    train_step, _, latent_step = plc_train.make_plc_train_step(CFG, TCFG)
    fn = train_step if which == "plc" else latent_step

    def step(state):
        head, opt = state
        metrics = fn(plc_train.PLCTrainState(head, opt, step=2), bb, a, tc, mask, SEED)
        return [metrics, *head.parameters(), *opt_state(opt)]
    return (head, loop.AdamW(list(head.parameters()), TCFG, 10)), step


def pretrain_case(dev, recipe: str) -> tuple:
    cfg = DacConfig()
    m = dac.init_dac_(dac.DAC(cfg), torch.Generator().manual_seed(5)).to(dev)
    opt = pb.generator_optimizer(m, TCFG, pb.warmup_cosine_lr(2e-4, 10, 1, 0.1))
    x, _ = waves(dev, 4, seed=6)
    if recipe == "recon":
        counts = torch.zeros(cfg.n_codebooks, cfg.codebook_size, device=dev)
        start = pb.PretrainState(m, opt, step=1, vq_counts=counts)
        step_fn = pb.make_pretrain_step(cfg, TCFG)[0]
    else:
        gcfg = GanConfig()
        d = gan.disc_init(gcfg, torch.Generator().manual_seed(7)).to(dev)
        start = pb.PretrainState(m, opt, step=1, d=d, d_opt=pb.disc_optimizer(d, TCFG, gcfg))
        step_fn = pb.make_gan_pretrain_step(cfg, TCFG, gcfg)[0]

    def step(state):
        metrics = step_fn(state, x, SEED)
        out = [metrics, *state.m.parameters(), *opt_state(state.opt)]
        if state.vq_counts is not None:
            out.append(state.vq_counts)
        if state.d is not None:
            out += [*state.d.parameters(), *opt_state(state.d_opt)]
        return out
    return start, step


CASES = {
    "head": lambda dev: head_case(dev, cached=False),
    "head_cached": lambda dev: head_case(dev, cached=True),
    "plc": lambda dev: plc_case(dev, "plc"),
    "plc_latent": lambda dev: plc_case(dev, "latent"),
    "decoder_ft": lambda dev: plc_case(dev, "decoder_ft"),
    "pretrain": lambda dev: pretrain_case(dev, "recon"),
    "pretrain_gan": lambda dev: pretrain_case(dev, "gan"),
}


def run_twice(start, step) -> tuple:
    """The step run on two deep copies of ``start`` -> (first, second)."""
    with fp32_exact():
        return step(copy.deepcopy(start)), step(copy.deepcopy(start))


def unequal(first: list, second: list) -> list:
    """Indices of the tensors that two runs left unequal."""
    return [i for i, (x, y) in enumerate(zip(first, second)) if not torch.equal(x, y)]


def events_ms(fn, reps: int) -> float:
    for _ in range(2):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, top: int = 0) -> tuple:
    """-> (the sum of torch.profiler's CUDA kernel times over one call in
    ms, the ``top`` kernel names with the most time: {name: [ms, launches]})."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_name: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:top]
    return sum(ms for ms, _ in by_name.values()), {k[:120]: list(v) for k, v in ranked}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--case", nargs="+", default=list(CASES), choices=list(CASES))
    ap.add_argument("--tag", default="")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--kernels", type=int, default=0,
                    help="also list this many kernels with the most time in one step")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("time_train_steps: no CUDA device", file=sys.stderr)
        return 1
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, timeout=60).stdout.strip()
    where = os.path.dirname(os.path.dirname(loop.__file__))
    dev = torch.device("cuda")
    for name in args.case:
        start, step = CASES[name](dev)
        first, second = run_twice(start, step)
        state = copy.deepcopy(start)
        with fp32_exact():
            ms = events_ms(lambda: step(state), args.reps)
            dms, top = device_ms(lambda: step(state), args.kernels)
        print(json.dumps({"tag": args.tag, "package": where, "card": card, "step": name,
                          "ms": ms, "device_ms": dms,
                          "twice_bit_equal": not unequal(first, second),
                          **({"kernels": top} if args.kernels else {})}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
