"""Smoke run of the PyTorch port on one CUDA card: build, check, serve.

    python3 chip_smoke.py [--seed N]

Drives the port's serving round trip (``StreamingCodec.encode_to_bytes`` ->
``decode_from_bytes``) at the full ``CodecConfig().with_rvq(8, 128)`` width,
in its default channels-first configuration (every stack through K1) and in
its time-major one (``time_major``, ``time_major_enc``, ``tail_kernel``,
``poly_upsample``: every narrow stack through K3), and holds every kernel of
the port against its plain PyTorch version. The weights are the round-5
trained checkpoints (``artifacts/r5``) where the checkout has them, else
random ones made from ``--seed``. Phases, one line of numbers each:

0. guard: a hang becomes a traceback and a non-zero exit after 900 s; the
   card's name and power limit;
1. build: the three CUDA libraries compiled from the repository's sources,
   one ``nvcc`` each, all started together, with each kernel's registers,
   spills and shared memory from ptxas (and the dynamic shared memory of
   each tensor-core tile and each fp32 FFMA tile); then ``sass``: the HMMA
   (tensor-core) instructions that ``cuobjdump -sass`` finds in the two
   stack libraries, which must be more than 0 in both, and in K2's library,
   which must hold no HMMA and no FFMA (its scores are separately rounded
   fp32 products and sums); and for each fp32 stack kernel function
   (``ffma_unit_kernel``) its FFMA, LDS.128 and HMMA counts, FFMA more than 0
   and no HMMA (true fp32: no tensor cores, no TF32);
2. kernel check, each kernel against its plain version on the same inputs:
   K1 (``resunit_stack``) at the eight stack shapes of the default path and
   K3 (``resunit_stack_tm``) at the four narrow ones of the time-major path,
   fp32 (FFMA; max relative error 1e-4, TF32 off; both also against an fp64
   run of the stack; K1 bit-equal to its plain version, reported at every
   shape and gated at the eight) and bf16 (tensor cores; 2e-2), each with
   its tile and launch grid, timed with CUDA events beside the plain version
   and cuDNN's convolutions of the same stack; then fp32 K1 at the eight
   shapes and K3 at the four at batch 8 (the trainers' batch), against the
   plain version (within 1e-4, K1's bit-equality reported) and timed beside
   cuDNN (reported, not gated on time); K2 (``rvq_lookup``)
   at the head RVQ's shapes, ties and ``n_books_use`` included (indices
   equal to the plain version's and to ``ops/rvq.py::rvq_quantize``'s,
   q_sum bit-equal), timed beside the plain version and the score products
   alone as one fp32 ``torch.matmul``, each by CUDA events (the host's time
   inside) and by device time (torch.profiler's kernel times), with K2's
   launch shape and its instance's registers and spills;
3. load: the codec's modules, read by the port's own checkpoint reader or
   made from the seed, moved to the card;
4. round trip, default configuration: fp32 and bf16 serving on a 1 s signal
   made from the seed, with the launch counters read around each call (8
   K1 stacks per encode and per receiver decode: 48 launches in fp32, 56 in
   bf16, whose stacks add a prologue each); the receiver's waveform
   against the transmitter's own decode; finite outputs; the fp32 path
   against the same path with every stack through the plain version
   (identical codes); bf16 against fp32 with the continuous-latent
   (< 2.5e-2) and wire-fidelity (within 1%) gates of docs/PARITY.md, taken
   over a batch of 64 one-second streams made from the seed, the single
   streams' ratios and the code agreement reported;
5. head RVQ path: the head RVQ inputs of one fp32 AR roll through
   ``rvq_quantize_fused`` (K2), with its counter read around it, and K2
   checked on them as in phase 2;
6. round trip, time-major configuration, fp32 and bf16: K3's launches per
   encode and per receiver decode (4 stacks: 24 in fp32, 28 in bf16; no
   K1); the fp32 continuous
   latent within 1e-5 of the same configuration with every stack through
   the plain versions and of the default configuration, and the decoder's
   output on one ``z_run`` within 1e-4 of the plain stacks' (codes
   reported); bf16 against fp32 with the PARITY gates over the 64 streams;
   bytes per stream at or below the nominal rate;
7. round trip, ``tail_kernel`` alone (channels-first, K3 between transposes
   and K1 on the wide stacks), bf16, with the same gates, which the same
   configuration with every stack through the plain versions meets too;
8. profile: device time of one bf16 encode and one receiver decode by
   kernel kind (torch.profiler), and the card's busy share, for the default
   and the time-major configuration;
9. small reference: the trained tiny codec of artifacts/evidence_tiny on the
   card against the same codec on the CPU (the plain path);
10. conceal: ``StreamingConcealer`` (packet-loss concealment) at the same
   full width, on the codec's backbones with a PLC head of 2 blocks made
   from the seed (``mask_embed`` on, as the trained tiny heads), on a
   uniform loss mask (``masks.make_token_loss_mask``, packets of 2 tokens,
   p 0.5): the launches of each call (8 K1 stacks: 56 in bf16, 48 in fp32;
   under ``tail_kernel`` 4 K3 and 4 K1 stacks: 28 and 28 in bf16), its
   latency by CUDA events, its device time, busy share and K1/K3 share by
   torch.profiler, and ``throughput_frames_per_sec`` (CUDA events; the
   codec's after its profile); fp32 through the kernels against the plain
   stacks (within 1e-5, bit-equality reported); with no token lost, the
   fp32 output against the tactile decoder of the same latents (within
   1e-6); the bf16 concealed latent stream against fp32 within
   docs/PARITY.md's continuous-latent 2.5e-2;
11. plc_eval: the PLC evaluators (uniform and category) on the trained tiny
   heads of artifacts/evidence_tiny and its 3 held-out pairs, the model on
   the card in fp32 (K1 at C 1-64, 120 launches a file): their summaries
   against MANIFEST.json's within its tolerances, and their wall time;
12. codec_eval: the codec evaluators (``eval_backbone_codec`` at n_q 1, 2,
   4, 8 and the proposed codec's rows), the model on the card in fp32, the
   latency map first (``scripts/measure_latencies.py::measure``: bf16, every
   stack through K1, CUDA events, p50/p95), then the rows with their K1
   launches counted (a batch of 3 is one forward: 8 stacks a backbone
   forward and one more encode probing the token rate, 12 stacks a proposed
   forward; 6 launches a stack in fp32). (a) The trained tiny codec of
   artifacts/evidence_tiny on its 3 held-out pairs against MANIFEST.json's
   ``dac_baseline`` and ``proposed`` rows within its tolerances, and the
   entropy-coded rates of its committed evaluation JSON (the same bytes).
   (b) The VC-PWQ codec built from ``native/vcpwq`` into ``build/vcpwq/``,
   the 16 corpus files coded at ``EvalConfig().vc_b_list``, and
   ``eval_vc_pwq``'s six rows against the MANIFEST's. (c) Full width on the
   same pairs: the round-5 sweep (``artifacts/r5``, its ``rvqB8_K128``
   found by ``eval_proposed_runs``) where the checkout has it, else the
   seeded codec through ``evaluate_proposed_model``, and the backbone's
   rows; every fp32 row through K1 against the same row with every stack
   through the plain version (codes and bytes equal, PSNR within 1e-4 dB,
   ST-SIM within 1e-6), and with r5 the entropy-coded rate within 1% of the
   JAX package's on the same pairs (4.3093 kbps; the nominal is 4.2).
   (d) The launches per forward, the latency columns and the phase's wall
   seconds;
13. parallel_roll: ``StreamingCodec(parallel_roll=True)`` (the two-pass AR
   roll) at full width, batch 1, 1 s, default layout, fp32 and bf16: the
   bytes round trip with its K1 launches (as the scan's: 48 / 56 a call);
   fp32 against the scan's over the 64 streams (the share of equal codes at
   least 0.999, bit-equality reported; z_run within 1e-5); bf16 against the
   scan's fp32 with docs/PARITY.md's gates over the 64 streams; each form's
   latency by CUDA events, its chained ``device_time_ms`` and its profiled
   device time, side by side;
14. train: the codec head's training entry point ``train/loop.py::train_codec``
   at full width (``CodecConfig`` with 10 books of 128 codes, the JAX
   script's default ``rvqB10_K128``, ``TrainConfig`` defaults: batch 6, 1 s
   segments at 24 kHz, lr 2e-4, clip 3.0) on a synthetic corpus of 24
   two-second pairs written by the port's ``data/synth.py`` under
   ``build/chip_smoke_train/``, the backbone of ``artifacts/r5`` where the
   checkout has it, else random from the seed (written there as a
   checkpoint for the hand-off), for 2 epochs with ``ema_warm_epochs`` 1 and
   ``best_after_epoch`` 0. Gates: the step functions launch K1 48 times a
   train step and 48 an eval step (the two frozen encoders' 8 fp32 stacks;
   the decoder runs its plain stacks with autograd), K3 and K2 never; after
   one step every AdamW leaf of the head has a finite gradient that is not
   all zero; one train step with the encoders through K1 against the same
   step with every stack through the plain versions, which launches no
   kernel (loss within 1e-6 relative, every head gradient within 1e-4 of
   its leaf's largest); the same train step (dropout, EMA and reseeding on)
   twice from one start gives bit-equal metrics, head, EMA books and counts,
   and optimizer state (F6); the run's books unchanged in epoch 1 and
   changed in epoch 2 (the EMA);
   ``last.msgpack`` and ``best.msgpack`` read back strictly equal to the
   live head at their epochs, ``hist.json`` with the JAX package's keys; the
   trained head through ``convert.load_codec`` and a ``StreamingCodec`` bytes
   round trip. Reported: train-step and eval-step ms by CUDA events, data
   wait per step, steps/s, K1's share of a train step's device time
   (torch.profiler), ``torch.cuda.max_memory_allocated``;
15. cached_train: head training on the frozen-backbone latent cache
   (``train/latent_cache.py``) with phase 14's configuration, corpus and
   backbone: the cache of the 24 whole two-second pairs built in batches of
   6 (K1 48 times a batch: the two frozen encoders' 8 fp32 stacks); a
   cached train step and a cached eval step on 1-s crops launch K1, K2 and K3
   0 times; the cached train step twice from one start is bit-equal, as
   in phase 14; a cached eval step on whole-file crops gives the generator
   path's eval loss on the same files within 1e-6 relative;
   ``train_codec(cache=...)`` for 2 epochs (20 train rows, 4 validation
   rows) launches no kernel, its books stay put in epoch 1 and move in epoch
   2, and ``last``/``best`` read back equal to the live head; ``run_sweep``
   over books (2, 4) x embed (128,) for 1 epoch on the cache writes both run
   directories and a ``sweep_summary.csv`` sorted by (est_kbps, best_val)
   with est_kbps the configuration's nominal rate, and a second call
   trains nothing and leaves every checkpoint's bytes as they were.
   Reported: the cache's bytes and build seconds; the cached train and eval
   step by CUDA events and by device time (torch.profiler), their busy
   share and the peak memory, beside phase 14's generator step; steps/s;
   the largest relative gap of a crop's interior tokens (``EDGE_TOKENS``
   from the edges) against live latents of the cropped waveform (not gated:
   the encoders' receptive field spans more than two tokens);
16. plc_train: ``plc/train.py::train_plc`` at full width, uniform packets,
   ``mask_embed`` on, the masked latent and time terms at 1.0 and 0.5 (the
   JAX script's defaults), batch 6, 2 epochs of which the first is the
   decoder-free latent regression, on phase 14's corpus and backbone. Gates:
   a full-loss waveform step launches K1 48 times; after one step every
   PLC-head leaf that the forward reads (all but ``tokennorm``, which it does
   not read, as in the JAX package) has a finite gradient that is not all
   zero; the step through K1 against the same step through the plain stacks
   (loss within 1e-6 relative, every gradient within 1e-4 of its leaf's
   largest); the step twice from one start is bit-equal, as in phase 14;
   ``last``/``best`` read back equal to the live head;
   ``plc_config_from_meta`` returns the run's ``PLCConfig``; the trained
   head serves through ``StreamingConcealer`` (bf16, 56 K1 launches). Then
   ``finetune_inpaint_decoder`` for 1 epoch: every backbone and head leaf
   bit-equal before and after, the written ``dec_plc.msgpack`` differs from
   the stock decoder; ``eval_plc_uniform`` on the 4 validation pairs with
   that decoder as ``dec_ft`` gives the zero-fill columns of the run
   without it and another concealed column. Reported: the step by CUDA
   events and device time, the peak memory, the phase's wall seconds;
17. pretrain: backbone pretraining (``train/pretrain_backbone.py``) at the
   full width of ``DacConfig()``, ``TrainConfig`` as the port's script sets
   it (batch 8, 1 s, lr 2e-4, clip 3.0, betas (0.8, 0.99)), on batches of
   ``stream_pretrain_batches`` (int16 wire, ``--seed``) with 2 validation
   batches from seed + 10000, under ``build/chip_smoke_pretrain/``. Both
   recipes resume from r5's ``backbone_best.msgpack`` (with the
   ``vq_counts.msgpack`` beside it) at epoch 1 where the checkout has it,
   else from a seeded init written as a checkpoint. Probes on one batch:
   a reconstruction, a GAN warm-up and a GAN step each launch K1, K2 and
   K3 0 times, the eval step K1 48 times (the encoder's and the decoder's
   4 fp32 stacks) and its loss lies within 1e-6 relative of the same step
   through the plain stacks; after the reconstruction step every backbone
   leaf has a finite gradient that is not all zero, after the GAN step
   every discriminator leaf too (but the output biases, whose hinge
   gradient is exactly 0 while every logit lies inside the margin), and a
   warm-up step leaves the discriminators as they were; a reconstruction
   step and a GAN step (quantizer dropout and reseeding on) each twice from
   one start give bit-equal losses, backbone, counts, discriminators and
   optimizer states (F6). Runs:
   ``pretrain_backbone`` for 2 epochs of 3 steps with quantizer dropout,
   (a) reconstruction, (b) GAN with ``start_epoch=2``: K1 only in the eval
   steps (192 launches a run), finite losses, the discriminators
   bit-equal to their init after epoch 1 and moved after epoch 2,
   ``last``/``best``/``vq_counts``/``disc_last`` read back equal to the
   live state at their epochs, ``hist.json`` with the JAX package's keys;
   the GAN run's backbone reloads through ``convert.load_dac`` and serves a
   bf16 ``encode_quantized`` and ``decode`` (56 K1 launches), finite.
   Reported: each step kind by CUDA events and by device time with its
   busy share, the reconstruction step by kernel kind, K1's share of the
   eval step, the peak memory, steps/s and the data wait a step over each
   run, a backbone checkpoint's write seconds and the phase's wall seconds;
18. demo: the port's ``scripts/demo_end_to_end.py`` at the full width of
   ``CodecConfig()`` under ``build/chip_smoke_demo/``, its depth cut
   (``DEMO_FLAGS``): 12 synthetic two-second pairs (10 train, 2 held out;
   the JAX default is 48), one pretraining epoch (30), one epoch a sweep
   head (30) over books (2, 8) x 128 (the default grid is 2, 6, 10), two
   PLC epochs (10) of which the first is the latent regression, batch 4
   (8), the heads on the latent cache (``--cached-heads``), both PLC modes,
   seed 7. Where the checkout has ``artifacts/r5/backbone_best.msgpack`` it
   is placed as the demo's ``backbone/best.msgpack`` and stage 2 reuses it;
   else stage 2 pretrains. Gates: every file of the reference contract
   (``contract_files``; the PNGs only where matplotlib is installed, else
   the demo's "not drawn" lines); every checkpoint reads back strictly
   through ``convert`` (the usage counts through ``train/checkpoint.py``);
   the combined JSON has the key tree of the committed
   ``artifacts/evidence_tiny`` JSON, its rows' rates are their
   configurations' nominal rates, and every metric and PLC summary value is
   finite (the stock-decoder columns are NaN without an inpainting
   decoder); each stage's modules and tensors lie on the card; K1's
   launches a call (``K1_PER_CALL``: 48 a pretraining eval batch and a
   cache-build batch, 216 a backbone-evaluator call, 72 a proposed forward
   and an example, 120 a PLC-evaluated file, 0 in every train step and
   cached epoch) and the number of calls of each kind; the PSNR that
   ``example_signals`` gives each example equals, within 1e-3 dB, the
   proposed evaluator's for that file alone, and their mean the best run's
   row. Reported: each stage's wall seconds, K1 launches, K1's time (CUDA
   events around each stack outside a graph capture) and peak memory;
19. evidence: the port's ``evidence_tiny check`` on the card (tiny config,
   under ``build/chip_smoke_evidence/``): ``_compare`` against
   ``MANIFEST.json`` finds no mismatch at its own tolerances (PSNR 0.2 dB,
   ST-SIM 0.01, kbps 1e-6), the regenerated corpus is byte-equal to the
   committed one, and K1's launches a call and the calls are gated as in
   phase 18 (nothing trains: the backbone is reused, the sweep's runs are
   trained, the PLC heads resume at their last epoch). Reported: the
   largest deviation from the MANIFEST by tolerance class and the stages;
20. mesh: the data-parallel mesh (``parallel/mesh.py``) at world size 1 on
   NCCL (``tcp://localhost``, a free port; NCCL takes one rank a card), so
   every all-reduce, all-gather and broadcast is a real NCCL call. Gates:
   the backend is NCCL; the full-width bf16 ``StreamingCodec`` bytes round
   trip with ``mesh=`` launches K1 56 times an encode and a receiver decode
   and gives the meshless call's codes, bytes and waveform exactly; one
   batch-6 head train step of phase 14's configuration and corpus with the
   mesh (48 K1 launches) gives the meshless step's metrics (losses and code
   usage) and head bit for bit, and two meshless steps from one start give
   the same metrics and head bit for bit (F6: the step sums in a fixed
   order; the largest gaps are reported); one
   pretraining eval step (batch 8, full-width backbone, 48 K1 launches)
   gives the meshless loss bit for bit. Reported: the encode's ms and the
   train step's device ms (torch.profiler) with and without the mesh;
21. dac_import: a seeded full-width ``DacConfig()`` backbone written as a
   descript-audio-codec state dict (``descript_state_dict``: weight norm
   split as ``weight_v`` = the weight and ``weight_g = ||v||``, the
   up-convolutions in ``[C_in, C_out, k]``, the quantizer's projections as
   1x1 convolutions) into ``build/chip_smoke_dac_import/``, read back by
   ``models/dac_import.py::load_torch_dac`` (``weights_only=True``). Gates:
   every weight within 2.5e-7 of its leaf's largest (``g * v / ||v||``
   rounds to an ulp); the encode's codes through K1 in fp32 equal the
   source backbone's (24 launches each; bf16's agreement reported: a
   weight an ulp off can round to another bf16 value);
22. tooling: ``StreamingCodec.cost_analysis`` (``utils/roofline.py``: FLOPs
   by ``FlopCounterMode``, unfused bytes by a dispatch-mode counter, on the
   plain path) of the bf16 encode and ``decode_from_codes`` at batch 1 and
   32, each with ``summarize`` against its profiled device ms and the card's
   peaks (``device_peaks``), and the closed-form encoder FLOPs
   (``utils/flops.py``) beside them; the native range coder
   (``eval/bitstream.py``, built from ``native/vcpwq`` into
   ``build/vcpwq/``) on the default round trip's codes: bytes equal to the
   pure coder's, each decoding the other's stream, and each one's host ms;
   ``utils/profiling.py``'s ``trace`` of one bf16 encode under ``timed``
   and ``annotate``, written under ``build/chip_smoke_trace/``: it holds
   kernel events and the annotation;
23. dual_encoder: ``CodecConfig.vmap_dual_encoder`` (both encoders in one
   pass, each stack one grouped launch, ``models/dac.py::dual_encode``).
   First the grouped kernels:
   K1 over two weight sets at the encoder's four stack shapes and K3 at its
   two narrow ones, batch 1, fp32 and bf16, bit-equal to two single-stack
   launches and within the kernel tolerances of the plain versions (gated),
   each timed by CUDA events beside the two single launches and cuDNN's
   grouped convolutions of the same stacks, with the bound of both stacks.
   Then ``StreamingCodec`` encodes, fp32 and bf16, batch 1 and 32, with the
   option off and on: K1 launches an encode 48 / 56 off and 24 / 28 on
   (gated), codes and ``z_run`` bit-equal to the sequential encoders'
   (gated: the convolutions outside the stacks run per encoder), the
   encode's ms by CUDA events and its device ms by kernel kind
   (torch.profiler) both ways; the fp32 codes of the 64 parity streams equal
   the sequential path's (gated), and bf16 against fp32 with
   docs/PARITY.md's gates over them.

The card's machine has no matplotlib: there the demo draws no figure and
says so in one line a set of figures; the model work behind each figure
runs all the same.

Phase 13 also gates F5: the bf16 encode's chained ``device_time_ms`` (CUDA
graph replays, ``eval/latency.py::measure_device_ms``) through the scan and
through the parallel roll lies within 0.9-2.0x the profiler's kernel sum of
one encode; the eager chain of Python calls that it replaced is printed
beside it.

Then a JSON line of per-kernel numbers and, last, the device line. An error
raises at once; a numeric gate that fails is reported when it fails, and the
script exits non-zero without a result once every phase has run. Needs one
card; refuses to run without one.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import dataclasses
import faulthandler
import json
import importlib.util
import os
from itertools import islice
import re
import shutil
import socket
import subprocess
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

from multimodal_vqvae_compression_audio_tactile_tpu_torch import _build
from multimodal_vqvae_compression_audio_tactile_tpu_torch.convert import (
    dac_template, dac_tree, decoder_leaves, disc_template, disc_tree, head_template, head_tree,
    load_codec, load_dac, load_decoder, load_plc, load_plc_head, plc_head_template,
    plc_head_tree)
from multimodal_vqvae_compression_audio_tactile_tpu_torch.core.config import (
    CodecConfig, DacConfig, EvalConfig, GanConfig, LossConfig, PLCConfig, RVQConfig,
    SweepConfig, TrainConfig)
from multimodal_vqvae_compression_audio_tactile_tpu_torch.core.precision import fp32_exact
from multimodal_vqvae_compression_audio_tactile_tpu_torch.data import (
    SegmentDataset, batch_iterator, pair_stems, split_items)
from multimodal_vqvae_compression_audio_tactile_tpu_torch.data import wire
from multimodal_vqvae_compression_audio_tactile_tpu_torch.data.synth import (
    make_synth_corpus, stream_pretrain_batches)
from multimodal_vqvae_compression_audio_tactile_tpu_torch.eval import dac_baseline, proposed, vcpwq
from multimodal_vqvae_compression_audio_tactile_tpu_torch.eval import metrics
from multimodal_vqvae_compression_audio_tactile_tpu_torch.eval.prepared import (
    equal_length_batches, prepare_pairs)
from multimodal_vqvae_compression_audio_tactile_tpu_torch.eval.serving import (
    StreamingCodec, StreamingConcealer)
from multimodal_vqvae_compression_audio_tactile_tpu_torch.losses import gan as gan_losses
from multimodal_vqvae_compression_audio_tactile_tpu_torch.models import allpred_ar, dac
from multimodal_vqvae_compression_audio_tactile_tpu_torch.ops import resunit, resunit_tm, rvq, vq
from multimodal_vqvae_compression_audio_tactile_tpu_torch.plc import masks
from multimodal_vqvae_compression_audio_tactile_tpu_torch.plc import model as plc
from multimodal_vqvae_compression_audio_tactile_tpu_torch.plc.eval_categories import (
    eval_plc_categories)
from multimodal_vqvae_compression_audio_tactile_tpu_torch.plc.eval_uniform import eval_plc_uniform
from multimodal_vqvae_compression_audio_tactile_tpu_torch.plc import train as plc_train
from multimodal_vqvae_compression_audio_tactile_tpu_torch.plc.train import plc_config_from_meta
from multimodal_vqvae_compression_audio_tactile_tpu_torch.scripts.build_latent_cache import (
    full_batches)
from multimodal_vqvae_compression_audio_tactile_tpu_torch.scripts.measure_latencies import (
    measure as measure_latencies)
from multimodal_vqvae_compression_audio_tactile_tpu_torch.scripts.time_train_steps import (
    opt_state, unequal)
from multimodal_vqvae_compression_audio_tactile_tpu_torch.train import checkpoint, latent_cache
from multimodal_vqvae_compression_audio_tactile_tpu_torch.train import loop as train_loop
from multimodal_vqvae_compression_audio_tactile_tpu_torch.train import pretrain_backbone as pb
from multimodal_vqvae_compression_audio_tactile_tpu_torch.train.sweep import run_sweep
from multimodal_vqvae_compression_audio_tactile_tpu_torch import convert
from multimodal_vqvae_compression_audio_tactile_tpu_torch.eval import plots
from multimodal_vqvae_compression_audio_tactile_tpu_torch.plc import eval_categories, eval_uniform
from multimodal_vqvae_compression_audio_tactile_tpu_torch.scripts import (
    demo_end_to_end, demo_eval_only, evidence_tiny)
from multimodal_vqvae_compression_audio_tactile_tpu_torch.utils import artifacts
from multimodal_vqvae_compression_audio_tactile_tpu_torch.eval import bitstream
from multimodal_vqvae_compression_audio_tactile_tpu_torch.models import dac_import
from multimodal_vqvae_compression_audio_tactile_tpu_torch.parallel import mesh as pmesh
from multimodal_vqvae_compression_audio_tactile_tpu_torch.utils import flops, profiling, roofline

# Published dense peaks of one H100 SXM at 700 W: fp32 outside the tensor
# cores, bf16 in them, and HBM3 bandwidth.
PEAK_FLOPS = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_BYTES = 3.35e12
TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# (C, T, trailing snake) of every stack on the default path at 1 s: the
# encoder's four blocks (each with its block snake) and the decoder's four
# (the last one carrying the decoder's out_snake).
STACKS = [(64, 24000, True), (128, 12000, True), (256, 3000, True),
          (512, 600, True), (768, 600, False), (384, 3000, False),
          (192, 12000, False), (96, 24000, True)]
# the narrow ones (C < 256), which the time-major path sends to K3
TM_STACKS = [s for s in STACKS if s[0] < dac.NARROW]
# (n_books, K, N, n_books_use, duplicated rows) of the head RVQ (D = 96):
# one AR chunk at batch 1; batch 32 x 75 tokens at K = 512; fewer books used
# than held; exact ties
RVQ_CASES = [(8, 128, 16, None, False), (10, 512, 2400, None, False),
             (3, 128, 75, 2, False), (4, 128, 300, None, True)]
PKG = "multimodal_vqvae_compression_audio_tactile_tpu"
KERNELS = {   # name -> (module with the wrapper and its counter, source, TPU kernel)
    "resunit_stack": (resunit, f"{PKG}_torch/csrc/resunit_stack.cu",
                      f"{PKG}/ops/resunit_pallas.py:159"),
    "resunit_stack_tm": (resunit_tm, f"{PKG}_torch/csrc/resunit_stack_tm.cu",
                         f"{PKG}/ops/resunit_tm_pallas.py:198"),
    "rvq_lookup": (vq, f"{PKG}_torch/csrc/rvq_lookup.cu", f"{PKG}/ops/vq_pallas.py:85"),
}
# One-second streams over which the bf16-against-fp32 gates are taken. With
# trained weights one stream's wire-fidelity ratio moves by a few percent
# from signal to signal in every configuration, plain stacks or kernels:
# each bf16 code flip re-routes the AR roll. A 1% gate needs the pooled
# error of many streams (docs/PARITY.md's own check pools 4).
PARITY_STREAMS = 64
TIME_MAJOR = dict(time_major=True, time_major_enc=True, tail_kernel=True,
                  poly_upsample=True)
REPO = os.path.dirname(os.path.abspath(__file__))
ARTIFACTS = os.path.join(REPO, "artifacts")
EVIDENCE = os.path.join(ARTIFACTS, "evidence_tiny")
R5 = (os.path.join(ARTIFACTS, "r5", "backbone_best.msgpack"),
      os.path.join(ARTIFACTS, "r5", "rvqB8_K128", "best.msgpack"))
T0 = time.perf_counter()
FAILED: list = []      # numeric gates that failed; checked once all phases ran


def gate(ok: bool, what: str) -> None:
    if not ok:
        FAILED.append(what)
        print(f"GATE FAILED: {what}", file=sys.stderr, flush=True)


def say(phase: str, **numbers) -> None:
    print(json.dumps({"phase": phase, "elapsed_s": round(time.perf_counter() - T0, 3),
                      **numbers}), flush=True)


def cuda_ms(fn, reps: int = 10, warm: int = 2) -> float:
    """Mean device time of ``fn`` in ms, by CUDA events around ``reps`` calls."""
    for _ in range(warm):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def device_ms(fn, reps: int = 10) -> float:
    """Device time of one call of ``fn`` in ms, the host's time left out:
    the mean CUDA kernel time that torch.profiler records over ``reps``
    calls, times the kernels a call launches. The profiler now and then
    drops kernel events, so the mean is over those it kept, and a profile
    that kept none is taken again."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    for _ in range(3):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us = [e.time_range.elapsed_us() for e in prof.events()
              if e.device_type == DeviceType.CUDA]
        if us:
            return sum(us) / len(us) * max(1, round(len(us) / reps)) / 1e3
    raise RuntimeError("torch.profiler recorded no kernel in three tries")


def rel_err(got: torch.Tensor, ref: torch.Tensor) -> float:
    ref = ref.double()
    return float((got.double() - ref).abs().max() / ref.abs().max().clamp_min(1e-12))


def dtype_name(dt: torch.dtype) -> str:
    return str(dt).split(".")[-1]


class Record:
    """One kernel's sums over the shapes it was checked at, per dtype: its
    time, its plain version's, the library call's, its bound (and any other
    time given, such as device times) and the worst absolute error against
    the plain version."""

    def __init__(self):
        self.sums: dict = {}
        self.max_abs_err: dict = {}

    def add(self, dt: torch.dtype, abs_err: float, **ms) -> None:
        tot = self.sums.setdefault(dt, {})
        for k, v in ms.items():
            tot[k] = tot.get(k, 0.0) + v
        self.max_abs_err[dt] = max(self.max_abs_err.get(dt, 0.0), abs_err)

    def report(self, name: str) -> None:
        for dt, tot in self.sums.items():
            say("kernel_totals", kernel=name, dtype=dtype_name(dt),
                max_abs_err=self.max_abs_err[dt], **tot)

    def line(self, name: str, dt: torch.dtype, launches: int) -> dict:
        """The kernel's entry in the ``kernels`` line, at ``dt``."""
        _, source, replaces = KERNELS[name]
        tot = self.sums[dt]
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches, "max_abs_err": self.max_abs_err[dt],
                "ms": tot["ms"], "plain_ms": tot["plain_ms"], "bound_ms": tot["bound_ms"],
                "bound_by": "operations" if tot["ops_ms"] >= tot["bytes_ms"] else "bytes",
                "library_ms": tot["library_ms"]}


def bound(flops: float, nbytes: float, dt: torch.dtype) -> dict:
    ops_ms, bytes_ms = flops / PEAK_FLOPS[dt] * 1e3, nbytes / PEAK_BYTES * 1e3
    return {"bound_ms": max(ops_ms, bytes_ms), "ops_ms": ops_ms, "bytes_ms": bytes_ms}


def stack_bound(c: int, t: int, dt: torch.dtype) -> dict:
    """Least time for one 3-unit stack at [1, C, T] or [1, T, C]: 16 C^2 T
    flops per unit against x read once, the output written once and each
    weight read once."""
    size = torch.finfo(dt).bits // 8
    return bound(3 * 16 * c * c * t, 2 * c * t * size + 3 * (8 * c * c * size + 4 * c * 4), dt)


def make_units(c: int, gen: torch.Generator, dev) -> list:
    units = [resunit.ResUnit(c) for _ in resunit.DILATIONS]
    with torch.no_grad():
        for u in units:
            bound_w = 1.0 / (7 * c) ** 0.5
            for p in (u.conv1.weight, u.conv1.bias, u.conv2.weight, u.conv2.bias):
                p.uniform_(-bound_w, bound_w, generator=gen)
            for s in (u.snake1, u.snake2):
                s.alpha.uniform_(0.5, 1.5, generator=gen)
    return [u.to(dev) for u in units]


def stack_fp64(units, x, post_alpha):
    """The stack on [B, C, T] in fp64 throughout, written out here
    independently of the port: the yardstick for both fp32 versions'
    rounding."""
    def sn(v, a):
        a = a.double()[None, :, None]
        return v + torch.sin(a * v) ** 2 / (a + 1e-9)

    x = x.double()
    for u, d in zip(units, resunit.DILATIONS):
        acc = torch.nn.functional.conv1d(sn(x, u.snake1.alpha), u.conv1.weight.double(),
                                         u.conv1.bias.double(), dilation=d, padding=3 * d)
        x = x + torch.nn.functional.conv1d(sn(acc, u.snake2.alpha), u.conv2.weight.double(),
                                           u.conv2.bias.double())
    return x if post_alpha is None else sn(x, post_alpha)


def cudnn_convs(units, x):
    """The stack's convolutions alone on [B, C, T], through cuDNN (the
    library yardstick)."""
    for u, d in zip(units, resunit.DILATIONS):
        h = torch.nn.functional.conv1d(x, u.conv1.weight.to(x.dtype), None,
                                       dilation=d, padding=3 * d)
        x = torch.nn.functional.conv1d(h, u.conv2.weight.to(x.dtype))
    return x


@torch.no_grad()
def check_stacks(name: str, stacks: list, time_major: bool, gen: torch.Generator) -> Record:
    """K1 (channels-first) or K3 (time-major) against its plain version at
    ``stacks``; the fp64 stack and cuDNN run on [1, C, T], the transposes
    made outside the timed region."""
    mod = resunit_tm if time_major else resunit
    kernel = resunit_tm.resunit_stack_tm if time_major else resunit.resunit_stack
    plain = resunit_tm.resunit_stack_tm_ref if time_major else resunit.resunit_stack_ref
    rec, dev, dils = Record(), torch.device("cuda"), resunit.DILATIONS
    for c, t, post in stacks:
        units = make_units(c, gen, dev)
        x32 = torch.randn(1, c, t, generator=gen).to(dev)
        pa = torch.empty(c).uniform_(0.5, 1.5, generator=gen).to(dev) if post else None
        exact = stack_fp64(units, x32, pa)
        for dt in TOL:
            x_nch = x32.to(dt)
            x = x_nch.transpose(1, 2).contiguous() if time_major else x_nch
            before = mod.launches
            got = kernel(units, x, dils, pa)
            ref = plain(units, x, dils, pa)
            torch.cuda.synchronize()
            gate(mod.launches == before + resunit.stack_launches(len(units), dt),
                 f"{name} did not launch")
            err = rel_err(got, ref)
            abs_err = float((got.float() - ref.float()).abs().max())
            gate(bool(torch.isfinite(got).all()) and err <= TOL[dt],
                 f"{name} vs plain at C={c} T={t} {dt}: rel {err:.3e} > {TOL[dt]:.0e}")
            vs64 = {}
            if dt == torch.float32:
                # both fp32 versions against fp64: each must err by sum order only
                to_nch = (lambda y: y.transpose(1, 2)) if time_major else (lambda y: y)
                vs64 = {"kernel_vs_fp64": rel_err(to_nch(got), exact),
                        "plain_vs_fp64": rel_err(to_nch(ref), exact)}
                gate(max(vs64.values()) <= TOL[dt],
                     f"{name} fp32 vs fp64 at C={c} T={t}: {vs64}")
            ms = {"ms": cuda_ms(lambda: kernel(units, x, dils, pa)),
                  "plain_ms": cuda_ms(lambda: plain(units, x, dils, pa)),
                  "library_ms": cuda_ms(lambda: cudnn_convs(units, x_nch)),
                  **stack_bound(c, t, dt)}
            rec.add(dt, abs_err, **ms)
            grid = resunit.launch_grid(c, t, 1, dt)
            fp32 = dt == torch.float32
            equal = bool(torch.equal(got, ref)) if fp32 else None
            if fp32 and not time_major:
                # the fp32 code-equality gates downstream rest on this
                gate(equal, f"{name} fp32 not bit-equal to plain at C={c} T={t}")
            say("kernel_check", kernel=name, C=c, T=t, dtype=dtype_name(dt),
                grid=grid, blocks=grid[0] * grid[1] * grid[2],
                tile=resunit.pick_ffma_tile(c, t) if fp32 else resunit.pick_tile(c, t),
                bit_equal=equal, rel_err=err, max_abs_err=abs_err, **vs64, **ms)
    rec.report(name)
    return rec


FP32_BATCH = 8   # the pretraining eval's batch (the head trainers': 6)


@torch.no_grad()
def check_fp32_batch(gen: torch.Generator) -> dict:
    """fp32 K1 at the eight stack shapes and K3 at the four at batch
    ``FP32_BATCH``: against the plain version (within 1e-4; K1's bit-equality
    reported), timed by CUDA events beside cuDNN's convolutions of the same
    stack. Reported, not gated on time."""
    dev, dils, sums = torch.device("cuda"), resunit.DILATIONS, {}
    for name, stacks, time_major in (("resunit_stack", STACKS, False),
                                     ("resunit_stack_tm", TM_STACKS, True)):
        kernel = resunit_tm.resunit_stack_tm if time_major else resunit.resunit_stack
        plain = resunit_tm.resunit_stack_tm_ref if time_major else resunit.resunit_stack_ref
        tot = sums.setdefault(name, {"ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0})
        for c, t, post in stacks:
            units = make_units(c, gen, dev)
            x_nch = torch.randn(FP32_BATCH, c, t, generator=gen).to(dev)
            x = x_nch.transpose(1, 2).contiguous() if time_major else x_nch
            pa = torch.empty(c).uniform_(0.5, 1.5, generator=gen).to(dev) if post else None
            got, ref = kernel(units, x, dils, pa), plain(units, x, dils, pa)
            torch.cuda.synchronize()
            err = rel_err(got, ref)
            gate(bool(torch.isfinite(got).all()) and err <= TOL[torch.float32],
                 f"{name} fp32 batch {FP32_BATCH} vs plain at C={c} T={t}: rel {err:.3e}")
            ms = {"ms": cuda_ms(lambda: kernel(units, x, dils, pa)),
                  "library_ms": cuda_ms(lambda: cudnn_convs(units, x_nch)),
                  "bound_ms": FP32_BATCH * stack_bound(c, t, torch.float32)["bound_ms"]}
            for k, v in ms.items():
                tot[k] += v
            say("kernel_check_batch", kernel=name, batch=FP32_BATCH, C=c, T=t, dtype="float32",
                tile=resunit.pick_ffma_tile(c, t, FP32_BATCH),
                grid=resunit.launch_grid(c, t, FP32_BATCH, torch.float32),
                bit_equal=bool(torch.equal(got, ref)), rel_err=err, **ms)
        say("kernel_totals_batch", kernel=name, batch=FP32_BATCH, dtype="float32", **tot)
    return sums


def rvq_bound(n: int, k: int, d: int, use: int) -> dict:
    """The score products (2 N K D per book) on the fp32 units against x and
    the books read once and q_sum and the indices written once."""
    return bound(2 * n * k * d * use, 4 * (2 * n * d + use * k * d + n * use),
                 torch.float32)


def rvq_instance(tokens: int) -> dict:
    """ptxas's registers and spills of K2's instance at ``tokens`` a block."""
    for name, numbers in ptxas_summary(_build.build_log.get("rvq", {}).get("ptxas", "")).items():
        if f"rvq_kernelILi{tokens}E" in name:
            return numbers
    return {}


@torch.no_grad()
def check_rvq(rec: Record, case: str, books: torch.Tensor, x: torch.Tensor,
              use=None) -> None:
    """K2 against its plain version and against ``ops/rvq.py::rvq_quantize``
    on x [N, D]: indices equal, q_sum bit-equal to the plain version's."""
    before = vq.launches
    q, idx = vq.rvq_lookup_fused(books, x, use)
    q_ref, idx_ref = vq.rvq_lookup_ref(books, x, use)
    _, idx_rvq = rvq.rvq_quantize(books, x.T[None], use)
    torch.cuda.synchronize()
    gate(vq.launches == before + 1, "rvq_lookup did not launch")
    same_ref = bool(torch.equal(idx, idx_ref))
    same_rvq = bool(torch.equal(idx, idx_rvq[0]))
    q_bits = bool(torch.equal(q, q_ref))
    abs_err = float((q - q_ref).abs().max())
    gate(same_ref and q_bits and same_rvq,
         f"rvq_lookup {case}: indices equal to plain {same_ref}, to rvq_quantize "
         f"{same_rvq}; q_sum bit-equal {q_bits}")
    n_use = idx.shape[1]
    sel = books[:n_use].float()
    kernel = lambda: vq.rvq_lookup_fused(books, x, use)
    library = lambda: torch.matmul(x[None], sel.transpose(1, 2))
    ms = {"ms": cuda_ms(kernel), "device_ms": device_ms(kernel),
          "plain_ms": cuda_ms(lambda: vq.rvq_lookup_ref(books, x, use), reps=3),
          "library_ms": cuda_ms(library), "library_device_ms": device_ms(library),
          **rvq_bound(x.shape[0], books.shape[1], x.shape[1], n_use)}
    rec.add(torch.float32, abs_err, **ms)
    # a checkout from before K2's redesign has no plan: this script then
    # times its kernel all the same
    launch = vq.plan(x.shape[0], books.shape[1], x.shape[1]) if hasattr(vq, "plan") else {}
    say("kernel_check", kernel="rvq_lookup", case=case, N=x.shape[0], books=n_use,
        K=books.shape[1], indices_equal_plain=same_ref, indices_equal_rvq_quantize=same_rvq,
        q_sum_bit_equal=q_bits, max_abs_err=abs_err, **ms,
        device_ms_by="torch.profiler, mean kernel time a call", launch=launch,
        ptxas=rvq_instance(launch.get("tokens_per_block", 0)))


def check_rvq_cases(gen: torch.Generator) -> None:
    rec, dev, D = Record(), torch.device("cuda"), 96
    for n_books, K, N, use, dup in RVQ_CASES:
        books = torch.randn(n_books, K, D, generator=gen) / D ** 0.5
        if dup:
            books[:, K // 2:] = books[:, :K // 2]      # every score tied with an earlier one
        x = torch.randn(N, D, generator=gen)
        check_rvq(rec, f"N{N}_books{n_books}_K{K}_use{use}{'_ties' if dup else ''}",
                  books.to(dev), x.to(dev), use)
    rec.report("rvq_lookup")


def signal(seed: int, frame: int) -> tuple:
    """1 s of audio and tactile-like signal: a few partials plus noise."""
    rng = np.random.default_rng(seed)
    t = np.arange(frame) / 24000.0
    out = []
    for _ in range(2):
        f = rng.uniform(80.0, 2000.0, size=4)
        x = sum(0.1 * np.sin(2 * np.pi * fi * t + rng.uniform(0, 6.3)) for fi in f)
        out.append((x + 0.02 * rng.standard_normal(frame)).astype(np.float32)[None, None])
    return out[0], out[1]


def signals(seed: int, n: int, frame: int) -> tuple:
    """``n`` streams, the first the main path's signal: [n, 1, frame] each."""
    pairs = [signal(seed + i, frame) for i in range(n)]
    return tuple(np.concatenate(x) for x in zip(*pairs))


def counted(fn):
    """Run ``fn`` with every kernel's launch counter set to 0 just before;
    -> (result, {kernel: launches}, host ms to the synchronised end)."""
    torch.cuda.synchronize()
    for mod, _, _ in KERNELS.values():
        mod.launches = 0
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return (out, {name: mod.launches for name, (mod, _, _) in KERNELS.items()},
            (time.perf_counter() - t0) * 1e3)


@contextlib.contextmanager
def plain_stacks():
    """Run the model's residual-unit stacks through the plain PyTorch versions
    (for an end-to-end comparison; the kernels' counters do not move)."""
    dac.resunit_stack = resunit.resunit_stack_ref
    dac.resunit_stack_tm = resunit_tm.resunit_stack_tm_ref
    try:
        yield
    finally:
        dac.resunit_stack = resunit.resunit_stack
        dac.resunit_stack_tm = resunit_tm.resunit_stack_tm


def serve(m, name: str, fast: bool, a, tc, expect: dict, flags: dict) -> dict:
    """One configuration's bytes round trip with its launch counts gated,
    its latencies, its wire rate and the tactile encoder's continuous latent.
    ``fast`` serves in bf16, else in fp32."""
    sc = StreamingCodec(m, batch=1, frame_sec=1.0, fast=fast, compute_dtype=dtype_of(fast),
                        **flags)
    streams, n_enc, enc_host_ms = counted(lambda: sc.encode_to_bytes(a, tc))
    y, n_dec, dec_host_ms = counted(lambda: sc.decode_from_bytes(a, streams))
    gate(n_enc == expect and n_dec == expect,
         f"{name}: launches encode {n_enc} / decode {n_dec}, expected {expect} each")
    gate(y.shape == (1, 1, 24000) and bool(torch.isfinite(y).all()),
         f"{name}: decoded waveform not finite or mis-shaped")
    z_run, codes = sc.encode(a, tc)
    y_tx = sc.decode(z_run)
    rx_vs_tx = rel_err(y, y_tx)
    enc_ms = cuda_ms(lambda: sc.encode(a, tc), reps=5)
    dec_ms = cuda_ms(lambda: sc.decode_from_codes(a, codes), reps=5)
    with torch.no_grad(), fp32_exact(not fast):
        zc = m.tactile_dac.encoder(torch.from_numpy(tc).cuda().to(sc.dtype),
                                   sc.cfg.dac).float()
    nbytes = len(streams[0])
    say("round_trip", mode=name, launches_encode=n_enc, launches_decode=n_dec,
        encode_ms=enc_ms, decode_ms=dec_ms, encode_to_bytes_host_ms=enc_host_ms,
        decode_from_bytes_host_ms=dec_host_ms, bytes_per_stream=nbytes,
        kbps=nbytes * 8 / 1000.0, nominal_kbps=sc.cfg.kbps(),
        receiver_vs_transmitter_rel_err=rx_vs_tx)
    gate(rx_vs_tx <= (5e-2 if fast else 1e-3),
         f"{name}: receiver decode differs from the transmitter's by {rx_vs_tx:.3e}")
    gate(nbytes * 8 / 1000.0 <= sc.cfg.kbps(),
         f"{name}: {nbytes * 8 / 1000.0} kbps above the nominal {sc.cfg.kbps()}")
    return {"codec": sc, "codes": codes.cpu().numpy(), "z_run": z_run.float(), "zc": zc,
            "y": y, "launches": {k: n_enc[k] + n_dec[k] for k in n_enc}}


@torch.no_grad()
def latents(m, fast: bool, flags: dict, streams: tuple) -> dict:
    """One configuration's encode of a batch of streams: the wire's latent,
    the codes and the tactile encoder's continuous latent."""
    a, tc = streams
    sc = StreamingCodec(m, batch=a.shape[0], frame_sec=1.0, fast=fast,
                        compute_dtype=dtype_of(fast), **flags)
    z_run, codes = sc.encode(a, tc)
    with fp32_exact(not fast):
        zc = m.tactile_dac.encoder(torch.from_numpy(tc).cuda().to(sc.dtype), sc.cfg.dac)
    return {"z_run": z_run.float(), "zc": zc.float(), "codes": codes.cpu().numpy()}


def parity(name: str, f32: dict, b16: dict) -> None:
    """bf16 against fp32 over a batch of streams: docs/PARITY.md's
    continuous-latent and wire-fidelity gates, the latter on the squared
    wire error pooled over the streams. Code agreement and the single
    streams' ratios are reported, not gated. PARITY.md's 0.97 holds two
    bf16 implementations against each other; bf16 against fp32 moves the
    latent by ~0.3-1%, as large as the residual that the deeper books
    quantize, and the AR roll carries each flip into the next chunk. The JAX
    package's own bf16 serving agrees with its fp32 on 0.81-0.92 of book 0
    and 0.08-0.16 of book 7 with the trained round-5 weights
    (tests/test_torch_allpred_ar.py::test_r5_bf16_agrees_with_fp32_as_jax_does)."""
    z_err = rel_err(b16["zc"], f32["zc"])
    agree = (b16["codes"] == f32["codes"]).mean(axis=(0, 1))
    ref = f32["zc"]
    sq = {k: ((r["z_run"] - ref) ** 2).mean(dim=(1, 2))      # per stream
          for k, r in (("fp32", f32), ("bf16", b16))}
    power = float((ref ** 2).mean())
    fid = {k: float(v.mean()) / power for k, v in sq.items()}
    ratio = fid["bf16"] / max(fid["fp32"], 1e-12)
    single = (sq["bf16"] / sq["fp32"].clamp_min(1e-30)).double().cpu().numpy()
    say("parity_bf16_vs_fp32", mode=name, streams=len(single), z_continuous_rel_err=z_err,
        per_book_code_agreement=[float(x) for x in agree],
        code_agreement=float(agree.mean()), wire_fidelity_relmse=fid,
        fidelity_ratio=ratio, single_stream_ratio_first=float(single[0]),
        single_stream_ratio_min=float(single.min()),
        single_stream_ratio_max=float(single.max()),
        single_stream_ratio_std=float(single.std()),
        single_streams_outside_1pct=int((abs(single - 1.0) >= 1e-2).sum()))
    gate(z_err < 2.5e-2, f"{name}: bf16 continuous-latent rel err {z_err:.3e} >= 2.5e-2")
    gate(abs(ratio - 1.0) < 1e-2, f"{name}: bf16 wire-fidelity ratio {ratio:.4f} not within 1%")


def dtype_of(fast: bool) -> torch.dtype:
    return torch.bfloat16 if fast else torch.float32


def expect(fast: bool, k1: int = 0, k3: int = 0) -> dict:
    """Launches of k1 K1 stacks and k3 K3 stacks of 3 units each."""
    per_stack = resunit.stack_launches(len(resunit.DILATIONS), dtype_of(fast))
    return {"resunit_stack": k1 * per_stack, "resunit_stack_tm": k3 * per_stack,
            "rvq_lookup": 0}


def round_trip(m: allpred_ar.CodecModules, a, tc, many: tuple) -> dict:
    """The default configuration: every stack through K1, 2 encoders x 4
    stacks on encode, encoder + decoder likewise on the receiver's decode.
    Its fp32 encode of the ``many`` streams is every bf16 parity's reference."""
    res = {name: serve(m, name, fast, a, tc, expect(fast, k1=8), {})
           for name, fast in (("fp32", False), ("bf16", True))}
    # the fp32 main path with every stack through the plain version instead
    sc = res["fp32"]["codec"]
    with plain_stacks():
        (_, codes_p), n_enc, _ = counted(lambda: sc.encode(a, tc))
        y_p, n_dec, _ = counted(lambda: sc.decode_from_codes(a, codes_p))
    gate(not any(n_enc.values()) and not any(n_dec.values()), "plain run launched a kernel")
    same = bool((codes_p.cpu().numpy() == res["fp32"]["codes"]).all())
    y_err = rel_err(res["fp32"]["y"], y_p)
    say("kernel_vs_plain_fp32_end_to_end", mode="default", codes_identical=same,
        waveform_rel_err=y_err)
    gate(same, "fp32 codes through K1 differ from the plain path's")
    gate(y_err <= 1e-4, f"fp32 waveform through K1 differs from the plain path's by {y_err:.3e}")
    res["fp32_many"] = latents(m, False, {}, many)
    parity("default", res["fp32_many"], latents(m, True, {}, many))
    return res


def time_major_round_trip(m: allpred_ar.CodecModules, a, tc, many: tuple,
                          default: dict) -> dict:
    """The time-major configuration: the narrow stacks through K3 (2 encoders
    x 2 stacks on encode; the audio encoder's 2 and the decoder's 2 on the
    receiver's decode), the wide ones through the time-major chain, no K1."""
    res = {name: serve(m, f"time_major_{name}", fast, a, tc, expect(fast, k3=4), TIME_MAJOR)
           for name, fast in (("fp32", False), ("bf16", True))}
    f32 = res["fp32"]
    sc = f32["codec"]
    x_tc = torch.from_numpy(tc).cuda()
    with torch.no_grad(), plain_stacks(), fp32_exact():
        (zc_p, (_, codes_p), y_p), counts, _ = counted(lambda: (
            m.tactile_dac.encoder(x_tc, sc.cfg.dac).float(), sc.encode(a, tc),
            sc.decode(f32["z_run"])))
    gate(not any(counts.values()), f"plain time-major run launched a kernel: {counts}")
    y_k = sc.decode(f32["z_run"])
    zc_err = rel_err(f32["zc"], zc_p)
    dec_err = rel_err(y_k, y_p)
    zc_vs_default = rel_err(f32["zc"], default["fp32"]["zc"])
    agree = float((codes_p.cpu().numpy() == f32["codes"]).mean())
    say("kernel_vs_plain_fp32_end_to_end", mode="time_major", zc_rel_err=zc_err,
        decoder_rel_err_same_z_run=dec_err, code_agreement_vs_plain=agree,
        zc_rel_err_vs_default_config=zc_vs_default,
        code_agreement_vs_default_config=float((f32["codes"] == default["fp32"]["codes"]).mean()))
    gate(zc_err <= 1e-5, f"time-major fp32 latent through K3 differs from plain by {zc_err:.3e}")
    gate(dec_err <= 1e-4, f"time-major fp32 decode through K3 differs from plain by {dec_err:.3e}")
    gate(zc_vs_default <= 1e-5,
         f"time-major fp32 latent differs from the default configuration's by {zc_vs_default:.3e}")
    parity("time_major", default["fp32_many"], latents(m, True, TIME_MAJOR, many))
    return res


def tail_kernel_round_trip(m, a, tc, many: tuple, default: dict) -> dict:
    """``tail_kernel`` alone, channels-first, bf16: the narrow stacks through
    K3 between transposes, the wide ones through K1 (2 a side of each 4-stack
    backbone); held to the default configuration's fp32, as is the same
    configuration through the plain stacks."""
    flags = {"tail_kernel": True}
    b16 = serve(m, "tail_kernel_bf16", True, a, tc, expect(True, k1=4, k3=4), flags)
    parity("tail_kernel", default["fp32_many"], latents(m, True, flags, many))
    with plain_stacks():
        plain = latents(m, True, flags, many)
    parity("tail_kernel_plain_stacks", default["fp32_many"], plain)
    return b16


@torch.no_grad()
def head_rvq_path(m: allpred_ar.CodecModules, a, tc) -> tuple:
    """The head RVQ inputs of one fp32 AR roll (one [1, 96, 16] chunk at a
    time) through ``rvq_quantize_fused`` with the counters at 0 just before;
    then K2 checked on each chunk as in the kernel check. -> (K2's launches,
    its record over the chunks)."""
    sc = StreamingCodec(m, batch=1, frame_sec=1.0, fast=False, compute_dtype=torch.float32)
    inputs = []

    def capture(books, z, n_books_use=None):
        inputs.append(z.detach().clone())
        return rvq.rvq_quantize(books, z, n_books_use)

    allpred_ar.rvq_quantize = capture
    try:
        _, codes = sc.encode(a, tc)
    finally:
        allpred_ar.rvq_quantize = rvq.rvq_quantize
    books = m.head.vq_books.detach()
    out, counts, host_ms = counted(lambda: [vq.rvq_quantize_fused(books, z) for z in inputs])
    fused = torch.cat([idx for _, idx in out], dim=1)[:, :codes.shape[1]]
    same = bool(torch.equal(fused, codes))
    say("head_rvq_path", chunks=len(inputs), launches=counts, host_ms=host_ms,
        codes_equal_ar_roll=same)
    gate(counts["rvq_lookup"] == len(inputs) > 0, f"K2 launches {counts}")
    gate(same, "K2 codes differ from the AR roll's")
    rec = Record()
    for i, z in enumerate(inputs):
        check_rvq(rec, f"ar_roll_chunk{i}", books, z[0].T.contiguous())
    rec.report("rvq_lookup")
    return counts["rvq_lookup"], rec


def kind_of(kernel: str) -> str:
    k = kernel.lower()
    if "mma_unit_kernel" in k or "prologue_kernel" in k:
        # the tensor-core stacks: the template's CF flag is true for K1
        head = k.replace("(anonymous namespace)", "").split("(")[0]
        return "K1 resunit_stack" if "true" in head else "K3 resunit_stack_tm"
    if "ffma_unit_kernel" in k:
        # the fp32 stacks, ffma_unit_kernel<KT, CF, SNAKE, ...>: CF is true for K1
        args = k.replace("(anonymous namespace)", "").split("(")[0].split("<")[1].split(",")
        return "K1 resunit_stack" if args[1].strip() == "true" else "K3 resunit_stack_tm"
    if "rvq_kernel" in k:
        return "K2 rvq_lookup"
    if any(s in k for s in ("conv", "cudnn", "xmma", "implicit", "wgrad", "dgrad")):
        return "cuDNN convolution"
    if any(s in k for s in ("gemm", "cutlass", "sm90_", "gemv", "cublas")):
        return "matmul"
    return "elementwise and other"


def profile_calls(name: str, calls: dict) -> dict:
    """Device time of one call of each of ``calls``, by kernel kind, from
    torch.profiler's CUDA kernel events; busy share = kernel time over the
    profiled wall time. -> {call: {"device_ms", "busy_share", "by_kind"}}."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    out = {}
    for call, fn in calls.items():
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        by_kind: dict = {}
        for e in kernels:
            kind = kind_of(e.name)
            ms, n = by_kind.get(kind, (0.0, 0))
            by_kind[kind] = (ms + e.time_range.elapsed_us() / 1e3, n + 1)
        busy = sum(ms for ms, _ in by_kind.values())
        kinds = {k: {"ms": ms, "launches": n} for k, (ms, n) in
                 sorted(by_kind.items(), key=lambda kv: -kv[1][0])}
        say("profile", mode=name, call=call, wall_ms_profiled=wall_ms, device_ms=busy,
            busy_share=busy / wall_ms if wall_ms else None, kernels=len(kernels),
            by_kind=kinds)
        out[call] = {"device_ms": busy, "busy_share": busy / wall_ms if wall_ms else None,
                     "by_kind": kinds}
    return out


def profile_phase(name: str, sc: StreamingCodec, a, tc, codes) -> None:
    """Device time of one bf16 encode and one receiver decode, by kernel kind."""
    profile_calls(name, {"encode": lambda: sc.encode(a, tc),
                         "decode_from_codes": lambda: sc.decode_from_codes(a, codes)})


def small_reference(seed: int) -> None:
    """The trained tiny codec of artifacts/evidence_tiny, read by the port's
    checkpoint reader, on the card (through K1) against the CPU (plain path)."""
    root = os.path.join(ARTIFACTS, "evidence_tiny")
    m_cpu = load_codec(os.path.join(root, "backbone", "best.msgpack"),
                       os.path.join(root, "sweep", "rvqB4_K32", "best.msgpack"),
                       CodecConfig().tiny().with_rvq(4, 32))
    m_gpu = copy.deepcopy(m_cpu).cuda()
    a, tc = (torch.from_numpy(x) for x in signal(seed + 1, 24000))
    _, codes_c = allpred_ar.encode_latents(m_cpu, a, tc)
    _, codes_g = allpred_ar.encode_latents(m_gpu, a.cuda(), tc.cuda())
    agree = float((codes_c == codes_g.cpu()).float().mean())
    y_c = allpred_ar.decode_from_codes(m_cpu, a, codes_c)
    y_g, counts, _ = counted(lambda: allpred_ar.decode_from_codes(m_gpu, a.cuda(),
                                                                   codes_c.cuda()))
    err = rel_err(y_g.cpu(), y_c)
    say("small_reference", code_agreement=agree, waveform_rel_err=err,
        k1_launches=counts["resunit_stack"])
    gate(agree == 1.0 and err <= 1e-4 and counts["resunit_stack"] == 48,
         "the trained tiny codec on the card disagrees with the CPU")


def concealer_modules(codec: allpred_ar.CodecModules, head: plc.PLCHead,
                      tail_kernel: bool) -> plc.PLCModules:
    """A concealment model on the codec's two backbones and ``head``, its
    config's ``tail_kernel`` set (``StreamingConcealer`` takes it from
    there, as the JAX package's takes it from ``cfg``)."""
    cfg = codec.cfg
    cfg = dataclasses.replace(cfg, dac=dataclasses.replace(cfg.dac, tail_kernel=tail_kernel))
    return plc.plc_of(codec.audio_dac, codec.tactile_dac, head, cfg)


@torch.no_grad()
def concealed_latents(pm: plc.PLCModules, a: torch.Tensor, zt_rx: torch.Tensor,
                      mk: torch.Tensor, fast: bool) -> torch.Tensor:
    """The concealed latent stream that ``conceal`` decodes (the predictor's
    tokens where lost, the received ones elsewhere), in the serving dtype."""
    dt, cfg = dtype_of(fast), pm.cfg.fast_serving() if fast else pm.cfg
    with fp32_exact(not fast):
        qa, _ = pm.audio_dac.quantizer.quantize(pm.audio_dac.encoder(a.to(dt), cfg.dac))
        z_pred, m3 = plc.predict_latents(pm.head, cfg, qa, zt_rx.to(dt), mk, mask_embed=True)
    return torch.where(m3, z_pred, zt_rx.to(dt))


@torch.no_grad()
def conceal_phase(codec: allpred_ar.CodecModules, seed: int, weights: str) -> None:
    """``StreamingConcealer`` at the codec's full width, batch 1, 1 s, in the
    default layout and under ``tail_kernel``, bf16 and fp32; see the module
    docstring (phase 10) for the gates."""
    cfg = codec.cfg
    head = plc.plc_head_init(cfg, torch.Generator().manual_seed(seed), n_layers=2).cuda()
    a_np, tc = signal(seed + 2, 24000)
    a = torch.from_numpy(a_np).cuda()
    mk = torch.from_numpy(masks.make_token_loss_mask(np.random.default_rng(seed), 1, 75,
                                                     2, 0.5)).cuda()
    with fp32_exact():
        zt = codec.tactile_dac.encoder(torch.from_numpy(tc).cuda(), cfg.dac)
    zt_rx = zt * ~mk[:, None, :]                   # what the receiver holds
    served = {}
    for layout, tail in (("default", False), ("tail_kernel", True)):
        pm = concealer_modules(codec, head, tail)
        for fast in (True, False):
            sc = StreamingConcealer(pm, batch=1, mask_embed=True, fast=fast,
                                    compute_dtype=dtype_of(fast))
            y, n, host_ms = counted(lambda: sc.conceal(a, zt_rx, mk))
            want = expect(fast, k1=4, k3=4) if tail else expect(fast, k1=8)
            name = f"conceal_{layout}_{dtype_name(dtype_of(fast))}"
            gate(n == want, f"{name}: launches {n}, expected {want}")
            gate(y.shape == (1, 1, 24000) and bool(torch.isfinite(y).all()),
                 f"{name}: concealed waveform not finite or mis-shaped")
            latency = cuda_ms(lambda: sc.conceal(a, zt_rx, mk), reps=10)
            say("conceal", layout=layout, dtype=dtype_name(dtype_of(fast)), launches=n,
                latency_ms=latency, first_call_host_ms=host_ms,
                lost_tokens=int(mk.sum()), backbone_weights=weights)
            served[(layout, fast)] = (sc, y)

    sc32, y32 = served[("default", False)]
    with plain_stacks():
        y_plain, n_plain, _ = counted(lambda: sc32.conceal(a, zt_rx, mk))
    gate(not any(n_plain.values()), f"plain conceal launched a kernel: {n_plain}")
    err_plain = rel_err(y32, y_plain)
    none = torch.zeros_like(mk)
    with fp32_exact():
        y_dec = codec.tactile_dac.decoder(zt, sc32.cfg.dac)
    err_none = rel_err(sc32.conceal(a, zt, none), y_dec)
    z = {fast: concealed_latents(concealer_modules(codec, head, False), a, zt_rx, mk, fast)
         for fast in (True, False)}
    z_err = rel_err(z[True].float(), z[False])
    say("conceal_checks", fp32_kernels_vs_plain_rel_err=err_plain,
        fp32_kernels_bit_equal_plain=bool(torch.equal(y32, y_plain)),
        no_loss_vs_tactile_decoder_rel_err=err_none,
        bf16_vs_fp32_concealed_latent_rel_err=z_err,
        bf16_vs_fp32_waveform_rel_err=rel_err(served[("default", True)][1], y32))
    gate(err_plain <= 1e-5, f"conceal fp32 through the kernels vs plain: {err_plain:.3e}")
    gate(err_none <= 1e-6, f"conceal with no loss vs the tactile decoder: {err_none:.3e}")
    gate(z_err < 2.5e-2, f"conceal bf16 concealed latent vs fp32: {z_err:.3e} >= 2.5e-2")

    say("conceal_throughput", layout="default", dtype="bfloat16",
        **served[("default", True)][0].throughput_frames_per_sec(repeats=10))
    for layout in ("default", "tail_kernel"):
        sc = served[(layout, True)][0]
        prof = profile_calls(f"conceal_{layout}_bfloat16",
                             {"conceal": lambda: sc.conceal(a, zt_rx, mk)})["conceal"]
        kinds = prof["by_kind"]
        say("conceal_profile", layout=layout, dtype="bfloat16", device_ms=prof["device_ms"],
            busy_share=prof["busy_share"],
            k1_share=kinds.get("K1 resunit_stack", {}).get("ms", 0.0) / prof["device_ms"],
            k3_share=kinds.get("K3 resunit_stack_tm", {}).get("ms", 0.0) / prof["device_ms"])


def plc_eval_phase() -> None:
    """The PLC evaluators on the trained tiny heads and the 3 held-out pairs
    of artifacts/evidence_tiny, the model on the card in fp32; the summaries
    against MANIFEST.json's within its tolerances."""
    with open(os.path.join(EVIDENCE, "MANIFEST.json")) as f:
        manifest = json.load(f)
    tol, ref = manifest["tolerances"], manifest["smoke_numbers"]
    _, pairs = split_items(pair_stems(os.path.join(EVIDENCE, "corpus", "audio"),
                                      os.path.join(EVIDENCE, "corpus", "tactile")), 0.2, 300, 7)
    out = os.path.join(REPO, "build", "chip_smoke_plc_eval")
    for mode, evaluate, files in (("uniform", eval_plc_uniform, len(pairs)),
                                  ("category", eval_plc_categories, 3 * len(pairs))):
        head_dir = os.path.join(EVIDENCE, f"plc_{mode}")
        pcfg = plc_config_from_meta(head_dir)
        m = load_plc(os.path.join(EVIDENCE, "backbone", "best.msgpack"), head_dir,
                     CodecConfig().tiny(), pcfg.n_layers)
        t0 = time.perf_counter()
        summary, counts, _ = counted(lambda: evaluate(m, pairs, os.path.join(out, mode), pcfg,
                                                      seed=7, log=lambda *_: None))
        wall_s = time.perf_counter() - t0
        want = ref[f"plc_{mode}"]
        flat = ([(want, summary)] if mode == "uniform"
                else [(want[c], summary[c]) for c in masks.CATEGORIES])
        worst = {"psnr_db": 0.0, "stsim": 0.0}
        for w, got in flat:
            for k, v in w.items():
                if k == "num_files" or np.isnan(v):        # counts; NaN without dec_ft
                    gate(got[k] == v or (np.isnan(v) and np.isnan(got[k])),
                         f"plc_eval {mode} {k}: {got[k]} against {v}")
                else:
                    key = "stsim" if "stsim" in k else "psnr_db"
                    worst[key] = max(worst[key], abs(got[k] - v))
        say("plc_eval", mode=mode, files=files, wall_s=wall_s, launches=counts,
            max_deviation_from_manifest=worst, tolerances=tol,
            mean_psnr_global_db=(summary["mean_psnr_global_db"] if mode == "uniform" else
                                 {c: summary[c]["mean_psnr_global_db"]
                                  for c in masks.CATEGORIES}))
        gate(worst["psnr_db"] <= tol["psnr_db"] and worst["stsim"] <= tol["stsim"],
             f"plc_eval {mode} off MANIFEST.json: {worst}")
        # per file: the concealed forward (3 encoders' and the decoder's
        # stacks) and the zero-fill floor (the tactile encoder and decoder)
        gate(counts["resunit_stack"] == files * 20 * resunit.stack_launches(3, torch.float32),
             f"plc_eval {mode}: K1 launches {counts}")


NQ = (1, 2, 4, 8)              # the backbone baseline's depths
# The round-5 codec's entropy-coded rate on the 3 held-out pairs, the same in
# both packages on the CPU (tests/test_torch_eval_codecs.py::
# test_r5_proposed_row_matches_jax): above the nominal 4.2 kbps, since the
# adaptive range coder pays its learning on 600 codes a file of synthetic
# signals the model was not trained on.
R5_KBPS_CODED = 4.309333333333333


def held_out_pairs() -> tuple:
    """The evidence corpus's 3 held-out pairs and their tactile peak."""
    _, pairs = split_items(pair_stems(os.path.join(EVIDENCE, "corpus", "audio"),
                                      os.path.join(EVIDENCE, "corpus", "tactile")), 0.2, 300, 7)
    return pairs, metrics.compute_global_peak([t for _, t, _ in pairs])


def evaluate(bb, cfg: CodecConfig, pairs, peak: float, lat: dict, sweep=None, codec=None) -> dict:
    """The backbone's rows at ``NQ`` and the proposed rows (every run under
    ``sweep``, or ``codec`` alone) in fp32 on the card, from the latency map
    ``lat``, each with its K1 launches."""
    ecfg, quiet = EvalConfig(), lambda *_: None
    dac24, n_dac, _ = counted(lambda: dac_baseline.eval_backbone_codec(
        bb, cfg.dac, pairs, peak, ecfg, n_q_list=NQ, latency_map=lat["backbone"], log=quiet))
    if sweep is not None:
        prop, n_prop, _ = counted(lambda: proposed.eval_proposed_runs(
            sweep, cfg, {"audio": bb, "tactile": bb}, pairs, peak, ecfg,
            latency_map=lat["runs"], log=quiet))
    else:
        prop, n_prop, _ = counted(lambda: [proposed.evaluate_proposed_model(
            codec, pairs, peak, ecfg=ecfg, latency=lat["runs"]["seeded"])])
    return {"dac24": dac24, "proposed": prop, "launches_dac24": n_dac["resunit_stack"],
            "launches_proposed": n_prop["resunit_stack"]}


def gate_launches(name: str, res: dict, n_runs: int) -> dict:
    """K1 launches of the rows: one forward of the batch of 3 per row (8
    stacks a backbone forward, and 4 for the token-rate probe; 12 a
    proposed one), 6 a stack in fp32. -> launches per forward."""
    per = resunit.stack_launches(3, torch.float32)
    want = {"dac24": (len(NQ) * 8 + 4) * per, "proposed": n_runs * 12 * per}
    got = {"dac24": res["launches_dac24"], "proposed": res["launches_proposed"]}
    gate(got == want, f"codec_eval {name}: K1 launches {got}, expected {want}")
    return {"backbone_forward": (got["dac24"] - 4 * per) // len(NQ),
            "proposed_forward": got["proposed"] // max(n_runs, 1)}


def against_manifest(name: str, rows: list, want: list, tol: dict) -> dict:
    """Worst deviation of ``rows`` from the MANIFEST's ``want``, gated on its
    tolerances."""
    worst = {"kbps": 0.0, "psnr_db": 0.0, "stsim": 0.0}
    gate(len(rows) == len(want), f"codec_eval {name}: {len(rows)} rows, expected {len(want)}")
    for g, w in zip(rows, want):
        for key, field in (("kbps", "kbps"), ("psnr_db", "psnr_mean"), ("stsim", "stsim_mean")):
            worst[key] = max(worst[key], abs(g[field] - w[field]))
    gate(all(worst[k] <= tol[k] for k in worst), f"codec_eval {name} off MANIFEST.json: {worst}")
    return worst


def latency_columns(lat: dict) -> dict:
    return {group: {k: {c: v[c] for c in ("enc_p50_ms", "enc_p95_ms", "dec_p50_ms", "dec_p95_ms")}
                    for k, v in lat[group].items()} for group in ("backbone", "runs")}


@torch.no_grad()
def codec_eval_phase(m: allpred_ar.CodecModules, weights: str) -> None:
    """The codec evaluators on the card; see the module docstring (phase 12)."""
    t_phase = time.perf_counter()
    ecfg = EvalConfig()
    pairs, peak = held_out_pairs()
    with open(os.path.join(EVIDENCE, "MANIFEST.json")) as f:
        manifest = json.load(f)
    tol, want = manifest["tolerances"], manifest["smoke_numbers"]

    # (a) the trained tiny codec against the MANIFEST
    t0 = time.perf_counter()
    tcfg, sweep = CodecConfig().tiny(), os.path.join(EVIDENCE, "sweep")
    tbb = load_dac(os.path.join(EVIDENCE, "backbone", "best.msgpack"), tcfg.dac).cuda()
    lat_tiny = measure_latencies(tbb, tcfg, sweep, NQ, ecfg)
    lat_tiny_s = time.perf_counter() - t0
    tiny = evaluate(tbb, tcfg, pairs, peak, lat_tiny, sweep=sweep)
    per_fwd_tiny = gate_launches("tiny", tiny, 2)
    worst = {"dac_baseline": against_manifest("tiny dac_baseline", [
                 tiny["dac24"][int(w["n_q"])] for w in want["dac_baseline"]],
                 want["dac_baseline"], tol),
             "proposed": against_manifest("tiny proposed", tiny["proposed"], want["proposed"],
                                          tol)}
    with open(os.path.join(EVIDENCE, "sweep", "eval_vs_backbone",
                           "eval_all_vs_backbone_rawPSNR_latency.json")) as f:
        committed = [r["kbps_entropy_coded"] for r in json.load(f)["proposed_runs"]]
    coded = [r["kbps_entropy_coded"] for r in tiny["proposed"]]
    gate(len(coded) == len(committed)
         and all(abs(g - c) <= tol["kbps"] for g, c in zip(coded, committed)),
         f"codec_eval tiny kbps_entropy_coded {coded}, committed {committed}")
    say("codec_eval_tiny", rows_wall_s=time.perf_counter() - t0 - lat_tiny_s,
        latency_wall_s=lat_tiny_s, launches_per_forward=per_fwd_tiny,
        max_deviation_from_manifest=worst, tolerances=tol, kbps_entropy_coded=coded,
        committed_kbps_entropy_coded=committed, latency_ms=latency_columns(lat_tiny),
        chained_time=lat_tiny.get("device_time"))

    # (b) VC-PWQ, built from source
    t0 = time.perf_counter()
    out = os.path.join(REPO, "build", "chip_smoke_codec_eval")
    shutil.rmtree(out, ignore_errors=True)
    exe = vcpwq.build_codec()
    build_s = time.perf_counter() - t0
    tact = os.path.join(EVIDENCE, "corpus", "tactile")
    vcpwq.code_corpus(tact, os.path.join(out, "dec"), os.path.join(out, "comp"),
                      ecfg.vc_b_list, codec=exe)
    vc = vcpwq.eval_vc_pwq(os.path.join(out, "dec"), os.path.join(out, "comp"), tact, peak,
                           ecfg, log=lambda *_: None)
    worst_vc = against_manifest("vc_pwq", vc, want["vc_pwq"], tol)
    gate(all(r["stream_version"] == "v2" and r["n"] == 16 for r in vc),
         f"codec_eval vc_pwq streams or files: {[(r['stream_version'], r['n']) for r in vc]}")
    say("codec_eval_vc_pwq", codec=os.path.relpath(exe, REPO), build_s=build_s,
        wall_s=time.perf_counter() - t0, budgets=[r["b"] for r in vc],
        kbps=[r["kbps"] for r in vc], max_deviation_from_manifest=worst_vc)

    # (c) full width: kernels against the plain stacks
    t0 = time.perf_counter()
    cfg = m.cfg
    if all(map(os.path.exists, R5)):
        sweep, codec = os.path.dirname(os.path.dirname(R5[1])), None
        lat = measure_latencies(m.tactile_dac, CodecConfig(), sweep, NQ, ecfg)
    else:
        sweep, codec = None, m
        lat = measure_latencies(m.tactile_dac, cfg, None, NQ, ecfg)
        lat["runs"]["seeded"] = proposed.measure_latency(m, cfg.rvq.n_books, ecfg)
    lat_s = time.perf_counter() - t0
    full = evaluate(m.tactile_dac, cfg, pairs, peak, lat, sweep=sweep, codec=codec)
    per_fwd = gate_launches("full width", full, 1)
    with plain_stacks():
        plain = evaluate(m.tactile_dac, cfg, pairs, peak, lat, sweep=sweep, codec=codec)
    gate(plain["launches_dac24"] == plain["launches_proposed"] == 0,
         "codec_eval: the plain-stack rows launched a kernel")
    _, A, T = next(equal_length_batches(prepare_pairs(pairs, cfg.dac.sample_rate), 16))
    A, T = torch.from_numpy(A).cuda(), torch.from_numpy(T).cuda()
    codes = {}
    for path, ctx in (("kernels", contextlib.nullcontext), ("plain", plain_stacks)):
        with ctx():
            codes[path] = (allpred_ar.encode_latents(m, A, T)[1],
                           dac.encode_quantized(m.tactile_dac, cfg.dac, T)[1])
    codes_equal = [bool(torch.equal(k, p)) for k, p in zip(codes["kernels"], codes["plain"])]
    rows_k = list(full["dac24"].values()) + full["proposed"]
    rows_p = list(plain["dac24"].values()) + plain["proposed"]
    d_psnr = max(abs(k["psnr_mean"] - p["psnr_mean"]) for k, p in zip(rows_k, rows_p))
    d_stsim = max(abs(k["stsim_mean"] - p["stsim_mean"]) for k, p in zip(rows_k, rows_p))
    same_bytes = all(k["kbps_entropy_coded"] == p["kbps_entropy_coded"]
                     for k, p in zip(full["proposed"], plain["proposed"]))
    gate(all(codes_equal) and same_bytes and d_psnr <= 1e-4 and d_stsim <= 1e-6,
         f"codec_eval full width, K1 against plain stacks: codes equal {codes_equal}, bytes "
         f"equal {same_bytes}, |dPSNR| {d_psnr:.3e} dB, |dST-SIM| {d_stsim:.3e}")
    coded = [r["kbps_entropy_coded"] for r in full["proposed"]]
    if sweep is not None:
        gate(len(coded) == 1 and abs(coded[0] / R5_KBPS_CODED - 1.0) <= 1e-2,
             f"codec_eval r5: entropy-coded {coded} kbps, the JAX package's {R5_KBPS_CODED}")
    say("codec_eval_full_width", weights=weights,
        runs=[r.get("run", "seeded") for r in full["proposed"]],
        rows_wall_s=time.perf_counter() - t0 - lat_s, latency_wall_s=lat_s,
        launches_per_forward=per_fwd, codes_equal_plain=codes_equal,
        bytes_equal_plain=same_bytes, max_abs_dpsnr_db=d_psnr, max_abs_dstsim=d_stsim,
        kbps_entropy_coded=coded, nominal_kbps=cfg.kbps(),
        psnr_mean={**{f"n_q{q}": r["psnr_mean"] for q, r in full["dac24"].items()},
                   **{r.get("run", "seeded"): r["psnr_mean"] for r in full["proposed"]}},
        latency_ms=latency_columns(lat), chained_time=lat.get("device_time"))
    say("codec_eval", wall_s=time.perf_counter() - t_phase,
        k1_launches_per_fp32_forward={"tiny": per_fwd_tiny, "full_width": per_fwd})


def parallel_roll_phase(m: allpred_ar.CodecModules, a, tc, many: tuple, default: dict) -> None:
    """``StreamingCodec(parallel_roll=True)``; see the module docstring
    (phase 13)."""
    flags = {"parallel_roll": True}
    res = {name: serve(m, f"parallel_roll_{name}", fast, a, tc, expect(fast, k1=8), flags)
           for name, fast in (("fp32", False), ("bf16", True))}
    f32 = latents(m, False, flags, many)
    ref = default["fp32_many"]
    agree = float((f32["codes"] == ref["codes"]).mean())
    z_err = rel_err(f32["z_run"], ref["z_run"])
    say("parallel_roll_vs_scan_fp32", streams=len(f32["codes"]), code_agreement=agree,
        codes_bit_equal=bool((f32["codes"] == ref["codes"]).all()),
        z_run_rel_err=z_err, z_run_bit_equal=bool(torch.equal(f32["z_run"], ref["z_run"])),
        batch1_codes_equal=bool((res["fp32"]["codes"] == default["fp32"]["codes"]).all()))
    gate(agree >= 0.999, f"parallel roll fp32 code agreement with the scan {agree:.5f} < 0.999")
    gate(z_err <= 1e-5, f"parallel roll fp32 z_run differs from the scan's by {z_err:.3e}")
    parity("parallel_roll", ref, latents(m, True, flags, many))
    for dt, scan, par in (("float32", default["fp32"], res["fp32"]),
                          ("bfloat16", default["bf16"], res["bf16"])):
        forms = {}
        for form, r in (("scan", scan), ("parallel", par)):
            sc = r["codec"]
            dtm = sc.device_time_ms(n_lo=4, n_hi=16, reps=2)
            prof = profile_calls(f"{form}_roll_{dt}", {"encode": lambda: sc.encode(a, tc)})
            chained, profiled = dtm["encode_ms_per_batch"], prof["encode"]["device_ms"]
            forms[form] = {"encode_events_ms": cuda_ms(lambda: sc.encode(a, tc), reps=5),
                           "decode_z_run_events_ms": cuda_ms(lambda: sc.decode(r["z_run"]),
                                                             reps=5),
                           "encode_chained_ms": chained,
                           "decode_z_run_chained_ms": dtm["decode_ms_per_batch"],
                           "encode_chained_spread_ms": dtm["encode"]["slope_spread_ms"],
                           "encode_profiled_device_ms": profiled,
                           "encode_chained_over_profiled": chained / profiled,
                           "encode_eager_chain_ms": eager_chain_ms(sc)}
            if dt == "bfloat16":
                # F5: the chain of graph replays reads the device's time
                gate(0.9 * profiled <= chained <= 2.0 * profiled,
                     f"F5: {form} bf16 encode chained {chained:.3f} ms, profiled kernel sum "
                     f"{profiled:.3f} ms: not within 0.9-2.0x")
        say("parallel_roll_latency", dtype=dt, **forms)


def eager_chain_ms(sc: StreamingCodec, n_lo: int = 4, n_hi: int = 16) -> float:
    """The chained encode slope as the port measured it before CUDA graphs:
    eager Python calls timed by CUDA events (best of 2 chains per length),
    for comparison with ``device_time_ms``."""
    rng = np.random.default_rng(3)
    a0, t0 = (sc._put((0.1 * rng.standard_normal((sc.batch, 1, sc.frame))).astype(np.float32))
              for _ in range(2))

    def chain(n):
        c = a0
        for _ in range(n):
            z = sc._encode(sc.modules, c, t0, n_books_use=sc.n_books_use, cfg=sc.cfg)[0]
            c = (t0 + 1e-6 * torch.tanh(z.float().mean())).to(c.dtype)
        return c.float().abs().sum()

    chain(n_lo)
    best = {n: min(cuda_ms(lambda: chain(n), reps=1, warm=0) for _ in range(2))
            for n in (n_lo, n_hi)}
    return (best[n_hi] - best[n_lo]) / (n_hi - n_lo)


TRAIN_DIR = os.path.join(REPO, "build", "chip_smoke_train")
HIST_KEYS = {"train", "val", "l1", "stft", "mel", "ema", "vq_bits", "vq_bits_min", "vq_used"}


def train_backbone(cfg: CodecConfig, seed: int) -> tuple:
    """(backbone module, its checkpoint, what it is): r5's trained backbone,
    or a random one from the seed written as a checkpoint for the hand-off."""
    if os.path.exists(R5[0]):
        return load_dac(R5[0], cfg.dac), R5[0], "artifacts/r5 backbone (trained)"
    bb = dac.init_dac_(dac.DAC(cfg.dac), torch.Generator().manual_seed(seed))
    path = os.path.join(TRAIN_DIR, "backbone.msgpack")
    checkpoint.save_checkpoint(path, dac_tree(bb), 0)
    return bb, path, f"random, seed {seed}"


def leaf_grad_errs(got: dict, ref: dict) -> dict:
    return {n: float((got[n] - ref[n]).abs().max() / ref[n].abs().max().clamp_min(1e-30))
            for n in ref}


def train_probes(cfg, tcfg, bb, batch_np, seed: int) -> dict:
    """The step functions on one batch: launches, gradients, K1 against the
    plain stacks, times, profile, memory."""
    a, tc = (torch.from_numpy(x).cuda() for x in batch_np)
    train_step, eval_step = train_loop.make_step_fns(cfg, tcfg)

    def fresh():
        head = allpred_ar.head_init(cfg, torch.Generator().manual_seed(seed)).cuda()
        m = allpred_ar.codec_of(bb, bb, head, cfg)
        return train_loop.TrainState(m, train_loop.AdamW(train_loop.adamw_params(head), tcfg,
                                                         3))

    def grads(state):
        return {n: p.grad.detach().clone() for n, p in state.head.named_parameters()
                if n != "vq_books"}

    out = {}
    with fp32_exact():
        torch.cuda.reset_peak_memory_stats()
        state = fresh()
        metrics, n_train, _ = counted(lambda: train_step(state, a, tc, seed + 1, do_ema=True))
        g = grads(state)
        bad = [n for n, t in g.items() if not bool(torch.isfinite(t).all())
               or not bool(t.abs().sum() > 0)]
        gate(not bad and len(g) == len(train_loop.adamw_params(state.head)),
             f"train: head gradients not finite or all zero after one step: {bad}")
        _, n_eval, _ = counted(lambda: eval_step(state.m, a, tc))
        want = expect(False, k1=8)
        gate(n_train == want and n_eval == want,
             f"train: launches a train step {n_train} / an eval step {n_eval}, expected {want}")

        ref_state = fresh()
        with plain_stacks():
            ref_metrics, n_plain, _ = counted(
                lambda: train_step(ref_state, a, tc, seed + 1, do_ema=True))
        gate(not any(n_plain.values()), f"train: plain step launched a kernel: {n_plain}")
        loss_rel = abs(float(metrics[0]) - float(ref_metrics[0])) / abs(float(ref_metrics[0]))
        errs = leaf_grad_errs(g, grads(ref_state))
        gate(loss_rel <= 1e-6 and max(errs.values()) <= 1e-4,
             f"train: K1 step against the plain stacks: loss {loss_rel:.3e}, "
             f"grads {max(errs.values()):.3e}")
        def step_once():
            st = fresh()
            met = train_step(st, a, tc, seed + 1, do_ema=True)
            return [met, *st.head.state_dict().values(), *opt_state(st.opt)]
        out.update(same_step_twice("train", step_once))
        out.update(launches_train_step=n_train, launches_eval_step=n_eval,
                   launches_plain_step=n_plain, loss=float(metrics[0]),
                   loss_rel_err_k1_vs_plain=loss_rel,
                   max_grad_rel_err_k1_vs_plain=max(errs.values()),
                   grads_bit_equal_k1_vs_plain=all(v == 0.0 for v in errs.values()))
        out["train_step_ms"] = cuda_ms(lambda: train_step(state, a, tc, seed + 1, True),
                                       reps=5, warm=1)
        out["eval_step_ms"] = cuda_ms(lambda: eval_step(state.m, a, tc), reps=5, warm=1)
        prof = profile_calls("train", {
            "train_step": lambda: train_step(state, a, tc, seed + 1, True),
            "eval_step": lambda: eval_step(state.m, a, tc)})
        out["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    for call, p in prof.items():
        k1 = p["by_kind"].get("K1 resunit_stack", {"ms": 0.0})["ms"]
        out[f"{call}_device_ms"] = p["device_ms"]
        out[f"{call}_k1_share"] = k1 / p["device_ms"] if p["device_ms"] else None
        out[f"{call}_busy_share"] = p["busy_share"]
    return out


def train_phase(seed: int, a, tc) -> dict:
    """The codec head's training on the card; see the module docstring
    (phase 14). -> what phases 15 and 16 reuse: the configuration, the
    corpus, the backbone and the generator step's numbers."""
    t_phase = time.perf_counter()
    cfg = CodecConfig(rvq=RVQConfig(n_books=10, n_embed=128, ema_warm_epochs=1))
    tcfg = TrainConfig(epochs=2, best_after_epoch=0)
    shutil.rmtree(TRAIN_DIR, ignore_errors=True)
    pairs = make_synth_corpus(os.path.join(TRAIN_DIR, "corpus"), n_pairs=24, dur_sec=2.0,
                              seed=seed)
    tr, va = split_items(pairs, tcfg.val_frac, tcfg.max_val, tcfg.seed)
    ds_tr = SegmentDataset(tr, sr=tcfg.target_sr, seg=tcfg.seg, seed=tcfg.seed)
    ds_va = SegmentDataset(va, sr=tcfg.target_sr, seg=tcfg.seg, seed=tcfg.seed)
    bb, bb_path, weights = train_backbone(cfg, seed)
    bb = bb.cuda().requires_grad_(False)
    probes = train_probes(cfg, tcfg, bb, next(batch_iterator(ds_tr, tcfg.batch, seed=seed)),
                          seed)

    waits: list = []

    def timed(batches):
        it = iter(batches)
        while True:
            t0 = time.perf_counter()
            b = next(it, None)
            if b is None:
                return
            waits.append(time.perf_counter() - t0)
            yield b

    books0 = allpred_ar.head_init(cfg, torch.Generator().manual_seed(seed)).vq_books.detach()
    seen: dict = {}

    def on_epoch(ep, head):           # the live head at each epoch's end
        seen[ep] = (checkpoint.snapshot(head_tree(head)), time.perf_counter() - t0)

    out_dir = os.path.join(TRAIN_DIR, "run")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist, n_run, _ = counted(lambda: train_loop.train_codec(
        cfg, tcfg, {"audio": bb, "tactile": bb},
        train_batches=lambda ep: timed(batch_iterator(ds_tr, tcfg.batch, seed=tcfg.seed,
                                                      epoch=ep)),
        val_batches=lambda: batch_iterator(ds_va, tcfg.batch, shuffle=False, drop_last=False),
        out_dir=out_dir, seed=seed, log=lambda s: print(f"[train] {s}", flush=True),
        on_epoch=on_epoch))
    run_s = time.perf_counter() - t0
    steps = len(ds_tr) // tcfg.batch
    n_waits = waits[steps:]                  # the counting pass over epoch 0 left out
    gate(len(n_waits) == tcfg.epochs * steps, f"train: {len(n_waits)} batches drawn")

    trees = {ep: v[0] for ep, v in seen.items()}
    b1, b2 = trees[1]["vq_books"].cpu(), trees[2]["vq_books"].cpu()
    ema_ok = torch.equal(b1, books0) and not torch.equal(b2, b1)
    gate(ema_ok and hist["ema"] == [0.0, 1.0],
         f"train: the books should move in epoch 2 only (ema {hist['ema']})")
    files = {}
    for name in ("last", "best"):
        tree, epoch, fhist = checkpoint.load_checkpoint(os.path.join(out_dir, f"{name}.msgpack"),
                                                        head_template(cfg))
        live = checkpoint.to_host(trees[epoch])
        same = all(np.array_equal(tree_at(tree, p), tree_at(live, p))
                   for p, _ in checkpoint.flatten(live))
        files[name] = {"epoch": epoch, "equal_live_head": same}
        gate(same and set(fhist) == HIST_KEYS, f"train: {name}.msgpack (epoch {epoch}) "
             f"differs from the live head or its hist keys {sorted(fhist)}")
    with open(os.path.join(out_dir, "hist.json")) as f:
        gate(set(json.load(f)) == HIST_KEYS, "train: hist.json keys")
    gate(files["last"]["epoch"] == 2 and all(np.isfinite(hist["train"] + hist["val"])),
         f"train: hist {hist}")

    # the hand-off: the trained head served through the bytes round trip
    m = load_codec(bb_path, os.path.join(out_dir, "best.msgpack"), cfg).cuda()
    serve(m, "trained_head", False, a, tc, expect(False, k1=8), {})
    say("train", weights=weights, config="rvqB10_K128", batch=tcfg.batch, seg=tcfg.seg,
        epochs=tcfg.epochs, steps_per_epoch=steps, val_pairs=len(ds_va), **probes,
        run_wall_s=run_s, steps_per_s=tcfg.epochs * steps / run_s,
        epoch_end_s=[seen[1][1], seen[2][1]],
        data_wait_ms_per_step=1e3 * float(np.mean(n_waits)),
        data_wait_ms_max=1e3 * float(np.max(n_waits)), launches_run=n_run,
        hist={k: hist[k] for k in ("train", "val", "vq_bits", "vq_used")}, files=files,
        ema_epoch2_only=ema_ok, wall_s=time.perf_counter() - t_phase)
    return {"cfg": cfg, "tcfg": tcfg, "pairs": pairs, "split": (tr, va), "bb": bb,
            "weights": weights, "probes": probes}


def step_times(calls: dict) -> dict:
    """Each call's ms by CUDA events (mean of 5 after a warm-up) and its
    device ms and busy share by torch.profiler."""
    out, prof = {}, profile_calls("cached_train", calls)
    for name, fn in calls.items():
        out[f"{name}_ms"] = cuda_ms(fn, reps=5, warm=1)
        out[f"{name}_device_ms"] = prof[name]["device_ms"]
        out[f"{name}_busy_share"] = prof[name]["busy_share"]
    return out


def cache_bytes(cache) -> int:
    return sum(t.numel() * t.element_size() for t in cache)


def interior_gap(m, cfg, cache, pairs_ds, seg_tok: int, tok0: int) -> dict:
    """The largest gap of a crop's interior tokens (``EDGE_TOKENS`` from
    either edge) against the live latents of the cropped waveform, relative
    to the live latents' largest, for row 0 of the cache."""
    hop, e = cfg.dac.hop, latent_cache.EDGE_TOKENS
    a, tcw = (torch.from_numpy(pairs_ds._prep(p)[None, :, tok0 * hop:(tok0 + seg_tok) * hop]
                               ).float().cuda() for p in pairs_ds.items[0][:2])
    with torch.no_grad(), fp32_exact():
        qa, zt = allpred_ar.backbone_latents(m, a, tcw, cfg)
    cqa, czt, _ = latent_cache.gather_crops(cache, torch.tensor([0]).cuda(),
                                            torch.tensor([tok0]).cuda(), seg_tok, hop)
    return {k: rel_err(c[..., e:seg_tok - e], live[..., e:seg_tok - e])
            for k, c, live in (("qa", cqa, qa), ("zt", czt, zt))}


def cached_train_phase(ctx: dict, seed: int) -> None:
    """Head training on the frozen-backbone latent cache; see the module
    docstring (phase 15)."""
    t_phase = time.perf_counter()
    cfg = ctx["cfg"]
    tcfg = dataclasses.replace(ctx["tcfg"], epochs=2, best_after_epoch=0)
    bb = ctx["bb"]
    bbs = {"audio": bb, "tactile": bb}
    pairs = ctx["pairs"]
    ds = SegmentDataset(pairs, sr=tcfg.target_sr, seg=tcfg.seg, seed=tcfg.seed)
    batches = list(full_batches(ds, pairs, tcfg.batch))
    seg_tok, hop = int(round(tcfg.seg_sec * cfg.dac.tokens_per_sec)), cfg.dac.hop

    # the build: the encoders once over the corpus, 48 K1 launches a batch
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    cache, n_build, _ = counted(lambda: latent_cache.build_latent_cache(bbs, cfg, iter(batches)))
    build_s = time.perf_counter() - t0
    want = {"resunit_stack": len(batches) * expect(False, k1=8)["resunit_stack"],
            "resunit_stack_tm": 0, "rvq_lookup": 0}
    gate(n_build == want, f"cached_train: cache build launches {n_build}, expected {want}")
    t_tok = cache.qa.shape[-1]

    # the step functions on the cache: no kernel launched
    train_step, eval_step = train_loop.make_step_fns(cfg, tcfg)
    head = allpred_ar.head_init(cfg, torch.Generator().manual_seed(seed)).cuda()
    m = allpred_ar.codec_of(bb, bb, head, cfg)
    state = train_loop.TrainState(m, train_loop.AdamW(train_loop.adamw_params(head), tcfg, 3))
    idx, tok0 = (torch.from_numpy(x[0]).cuda() for x in latent_cache.crop_index_arrays(
        np.arange(len(pairs)), t_tok, seg_tok, tcfg.batch, 1, seed, 1))
    qa, zt, tc = latent_cache.gather_crops(cache, idx, tok0, seg_tok, hop)
    with fp32_exact():
        torch.cuda.reset_peak_memory_stats()
        _, n_train, _ = counted(lambda: train_step(state, (qa, zt), tc, seed + 1, True))
        _, n_eval, _ = counted(lambda: eval_step(m, (qa, zt), tc))
        none = expect(False)
        gate(n_train == none and n_eval == none,
             f"cached_train: a cached train step launched {n_train}, an eval step {n_eval}")
        def cached_once():
            h = allpred_ar.head_init(cfg, torch.Generator().manual_seed(seed)).cuda()
            st = train_loop.TrainState(allpred_ar.codec_of(bb, bb, h, cfg), train_loop.AdamW(
                train_loop.adamw_params(h), tcfg, 3))
            met = train_step(st, (qa, zt), tc, seed + 1, True)
            return [met, *h.state_dict().values(), *opt_state(st.opt)]
        twice = same_step_twice("cached_train", cached_once)
        times = step_times({"cached_train_step": lambda: train_step(state, (qa, zt), tc,
                                                                    seed + 1, True),
                            "cached_eval_step": lambda: eval_step(m, (qa, zt), tc)})
        peak = torch.cuda.max_memory_allocated()
        # whole-file crops against the generator path's eval step on the files
        rows = torch.arange(tcfg.batch).cuda()
        wq, wz, wt = latent_cache.gather_crops(cache, rows, torch.zeros_like(rows), t_tok, hop)
        a_files, tc_files = (torch.from_numpy(x).cuda() for x in batches[0])
        cached_loss = float(eval_step(m, (wq, wz), wt)[0])
        live_loss = float(eval_step(m, a_files, tc_files)[0])
    loss_rel = abs(cached_loss - live_loss) / abs(live_loss)
    gate(loss_rel <= 1e-6, f"cached_train: whole-file cached eval loss {cached_loss} against "
         f"the generator path's {live_loss} ({loss_rel:.3e})")
    gap = interior_gap(m, cfg, cache, ds, seg_tok, t_tok // 2 - seg_tok // 2)

    # train_codec on the cache: books still in epoch 1, moved in epoch 2
    run_cfg = dataclasses.replace(cfg, rvq=dataclasses.replace(cfg.rvq, ema_warm_epochs=1))
    out_dir = os.path.join(TRAIN_DIR, "cached_run")
    books0 = allpred_ar.head_init(run_cfg, torch.Generator().manual_seed(seed)).vq_books.detach()
    seen: dict = {}

    def on_epoch(ep, h):
        seen[ep] = checkpoint.snapshot(head_tree(h))

    n_tr = len(pairs) - 4
    t0 = time.perf_counter()
    hist, n_run, _ = counted(lambda: train_loop.train_codec(
        run_cfg, tcfg, bbs, None, None, out_dir, seed=seed, cache=cache,
        cache_train_rows=list(range(n_tr)), cache_val_rows=list(range(n_tr, len(pairs))),
        seg_tok=seg_tok, on_epoch=on_epoch, log=lambda s: print(f"[cached] {s}", flush=True)))
    run_s = time.perf_counter() - t0
    gate(n_run == expect(False), f"cached_train: train_codec(cache=...) launched {n_run}")
    b1, b2 = seen[1]["vq_books"].cpu(), seen[2]["vq_books"].cpu()
    ema_ok = torch.equal(b1, books0) and not torch.equal(b2, b1)
    gate(ema_ok and hist["ema"] == [0.0, 1.0], f"cached_train: books (ema {hist['ema']})")
    files = {}
    for name in ("last", "best"):
        tree, epoch, _ = checkpoint.load_checkpoint(os.path.join(out_dir, f"{name}.msgpack"),
                                                    head_template(run_cfg))
        live = checkpoint.to_host(seen[epoch])
        same = all(np.array_equal(tree_at(tree, p), tree_at(live, p))
                   for p, _ in checkpoint.flatten(live))
        files[name] = {"epoch": epoch, "equal_live_head": same}
        gate(same, f"cached_train: {name}.msgpack (epoch {epoch}) differs from the live head")

    # the sweep on the cache, then again: nothing retrained, no byte changed
    sweep_root = os.path.join(TRAIN_DIR, "sweep")
    scfg = SweepConfig(books_grid=(2, 4), embed_grid=(128,))
    stcfg = dataclasses.replace(tcfg, epochs=1)
    kw = dict(cache=cache, cache_train_rows=list(range(n_tr)),
              cache_val_rows=list(range(n_tr, len(pairs))), seg_tok=seg_tok)
    t0 = time.perf_counter()
    rows_sw = run_sweep(cfg, stcfg, scfg, bbs, None, None, sweep_root, log=lambda s: None, **kw)
    sweep_s = time.perf_counter() - t0
    with open(os.path.join(sweep_root, "sweep_summary.csv")) as f:
        csv_rows = [line.strip().split(",") for line in f][1:]
    keys = [(float(r[5]), float(r[6])) for r in csv_rows]
    tps = cfg.dac.tokens_per_sec
    gate([r[0] for r in csv_rows] == ["rvqB2_K128", "rvqB4_K128"] and keys == sorted(keys)
         and all(float(r[5]) == cfg.with_rvq(int(r[1]), int(r[2])).kbps(tps) for r in csv_rows)
         and all(os.path.isdir(os.path.join(sweep_root, r[0])) for r in csv_rows),
         f"cached_train: sweep_summary.csv {csv_rows}")
    blobs = {os.path.join(d, f): open(os.path.join(d, f), "rb").read()
             for d, _, fs in os.walk(sweep_root) for f in fs if f.endswith(".msgpack")}
    logs: list = []
    _, n_again, _ = counted(lambda: run_sweep(cfg, stcfg, scfg, bbs, None, None, sweep_root,
                                              log=logs.append, **kw))
    unchanged = all(open(p, "rb").read() == b for p, b in blobs.items())
    gate(unchanged and sum("skip" in s for s in logs) == 2 and not any("Epoch" in s for s in logs)
         and n_again == expect(False),
         f"cached_train: the second sweep retrained or changed a checkpoint ({logs})")
    gen = ctx["probes"]
    say("cached_train", weights=ctx["weights"], config="rvqB10_K128", batch=tcfg.batch,
        seg_tok=seg_tok, cache_pairs=int(cache.qa.shape[0]), cache_tokens=int(t_tok),
        cache_bytes=cache_bytes(cache), cache_build_s=build_s,
        launches_cache_build=n_build, launches_cached_train_step=n_train,
        launches_cached_eval_step=n_eval, **times, **twice, max_memory_allocated_bytes=peak,
        generator_step={k: gen[k] for k in ("train_step_ms", "train_step_device_ms",
                                            "train_step_busy_share", "eval_step_ms",
                                            "eval_step_device_ms",
                                            "max_memory_allocated_bytes")},
        whole_file_eval_loss={"cached": cached_loss, "generator": live_loss,
                              "rel_err": loss_rel},
        interior_token_rel_gap=gap, edge_tokens=latent_cache.EDGE_TOKENS,
        run_wall_s=run_s, steps_per_s=tcfg.epochs * (n_tr // tcfg.batch) / run_s,
        hist={k: hist[k] for k in ("train", "val", "vq_bits", "vq_used")}, files=files,
        sweep=[{k: r[k] for k in ("run", "est_kbps", "best_val")} for r in rows_sw],
        sweep_wall_s=sweep_s, sweep_rerun_unchanged=unchanged,
        wall_s=time.perf_counter() - t_phase)


def plc_leaves_used(head: plc.PLCHead) -> dict:
    """The PLC head's leaves that the forward reads: all but ``tokennorm``
    (kept for checkpoint parity, as in the JAX package)."""
    return {n: p for n, p in head.named_parameters() if not n.startswith("tokennorm")}


def plc_train_probes(cfg, tcfg, pcfg, bb, batch_np, seed: int) -> dict:
    """One full-loss waveform step: launches, gradients, K1 against the
    plain stacks, times, memory."""
    a, tc = (torch.from_numpy(x).cuda() for x in batch_np)
    t_lat = int(round(tcfg.seg_sec * cfg.dac.tokens_per_sec))
    mk = torch.from_numpy(masks.make_token_loss_mask(np.random.default_rng(seed), a.shape[0],
                                                     t_lat, pcfg.packet_tok,
                                                     pcfg.packet_loss_prob)).cuda()
    bbs = {"audio": bb, "tactile": bb}
    train_step, eval_step, _ = plc_train.make_plc_train_step(cfg, tcfg, pcfg.mask_embed)

    def fresh():
        head = plc.plc_head_init(cfg, torch.Generator().manual_seed(seed), pcfg.n_layers).cuda()
        return plc_train.PLCTrainState(head, train_loop.AdamW(list(head.parameters()), tcfg, 3))

    def grads(state):
        return {n: p.grad.detach().clone() for n, p in plc_leaves_used(state.head).items()}

    out = {}
    with fp32_exact():
        torch.cuda.reset_peak_memory_stats()
        state = fresh()
        metrics, n_step, _ = counted(lambda: train_step(state, bbs, a, tc, mk, seed + 1))
        g = grads(state)
        bad = [n for n, t in g.items() if not bool(torch.isfinite(t).all())
               or not bool(t.abs().sum() > 0)]
        gate(not bad, f"plc_train: head gradients not finite or all zero after one step: {bad}")
        gate(n_step == expect(False, k1=8), f"plc_train: a waveform step launched {n_step}")
        ref_state = fresh()
        with plain_stacks():
            ref_metrics, n_plain, _ = counted(lambda: train_step(ref_state, bbs, a, tc, mk,
                                                                 seed + 1))
        gate(not any(n_plain.values()), f"plc_train: plain step launched a kernel: {n_plain}")
        loss_rel = abs(float(metrics[0]) - float(ref_metrics[0])) / abs(float(ref_metrics[0]))
        errs = leaf_grad_errs(g, grads(ref_state))
        gate(loss_rel <= 1e-6 and max(errs.values()) <= 1e-4,
             f"plc_train: K1 step against the plain stacks: loss {loss_rel:.3e}, "
             f"grads {max(errs.values()):.3e}")
        def plc_once():
            st = fresh()
            met = train_step(st, bbs, a, tc, mk, seed + 1)
            return [met, *st.head.state_dict().values(), *opt_state(st.opt)]
        out.update(same_step_twice("plc_train", plc_once))
        out.update(launches_step=n_step, launches_plain_step=n_plain,
                   loss=float(metrics[0]), loss_rel_err_k1_vs_plain=loss_rel,
                   max_grad_rel_err_k1_vs_plain=max(errs.values()))
        for name, fn in {"train_step": lambda: train_step(state, bbs, a, tc, mk, seed + 1),
                         "eval_step": lambda: eval_step(state.head, bbs, a, tc, mk)}.items():
            out[f"{name}_ms"] = cuda_ms(fn, reps=5, warm=1)
        prof = profile_calls("plc_train", {
            "train_step": lambda: train_step(state, bbs, a, tc, mk, seed + 1)})["train_step"]
        out.update(train_step_device_ms=prof["device_ms"], train_step_busy_share=prof["busy_share"],
                   max_memory_allocated_bytes=torch.cuda.max_memory_allocated())
    return out


def plc_train_phase(ctx: dict, seed: int) -> None:
    """The PLC trainer and the inpainting-decoder fine-tune at full width;
    see the module docstring (phase 16)."""
    t_phase = time.perf_counter()
    cfg = CodecConfig()
    tcfg = dataclasses.replace(ctx["tcfg"], epochs=2, best_after_epoch=0,
                               loss=LossConfig(w_plc_latent=1.0, w_plc_masked=0.5))
    pcfg = PLCConfig(mask_embed=True)
    bb = ctx["bb"]
    bbs = {"audio": bb, "tactile": bb}
    tr, va = ctx["split"]
    ds_tr = SegmentDataset(tr, sr=tcfg.target_sr, seg=tcfg.seg, seed=tcfg.seed)
    ds_va = SegmentDataset(va, sr=tcfg.target_sr, seg=tcfg.seg, seed=tcfg.seed)
    probes = plc_train_probes(cfg, tcfg, pcfg, bb,
                              next(batch_iterator(ds_tr, tcfg.batch, seed=seed)), seed)

    def batches(ep):
        return batch_iterator(ds_tr, tcfg.batch, seed=tcfg.seed, epoch=ep)

    def val_batches():
        return batch_iterator(ds_va, tcfg.batch, shuffle=False, drop_last=False)

    out_dir = os.path.join(TRAIN_DIR, "plc_run")
    seen: dict = {}

    def on_epoch(ep, h):
        seen[ep] = checkpoint.snapshot(plc_head_tree(h))

    t0 = time.perf_counter()
    hist, n_run, _ = counted(lambda: plc_train.train_plc(
        cfg, tcfg, pcfg, bbs, batches, val_batches, out_dir, seed=seed,
        latent_pretrain_epochs=1, on_epoch=on_epoch,
        log=lambda s: print(f"[plc_train] {s}", flush=True)))
    run_s = time.perf_counter() - t0
    files = {}
    for name in ("last", "best"):
        tree, epoch, _ = checkpoint.load_checkpoint(os.path.join(out_dir, f"{name}.msgpack"),
                                                    plc_head_template(cfg, pcfg.n_layers))
        live = checkpoint.to_host(seen[epoch])
        same = all(np.array_equal(tree_at(tree, p), tree_at(live, p))
                   for p, _ in checkpoint.flatten(live))
        files[name] = {"epoch": epoch, "equal_live_head": same}
        gate(same, f"plc_train: {name}.msgpack (epoch {epoch}) differs from the live head")
    gate(plc_train.plc_config_from_meta(out_dir) == pcfg and hist["tmse"][0] == 0.0
         and all(np.isfinite(hist["train"] + hist["val"])), f"plc_train: meta or hist {hist}")

    # the trained head served by the concealer
    head = load_plc_head(os.path.join(out_dir, "best.msgpack"), cfg, pcfg.n_layers).cuda()
    pm = plc.plc_of(bb, bb, head, cfg)
    a_np, tc_np = signal(seed + 5, 24000)
    mk = torch.from_numpy(masks.make_token_loss_mask(np.random.default_rng(seed), 1, 75,
                                                     pcfg.packet_tok, 0.5)).cuda()
    with torch.no_grad(), fp32_exact():
        zt = bb.encoder(torch.from_numpy(tc_np).cuda(), cfg.dac)
    scn = StreamingConcealer(pm, batch=1, mask_embed=pcfg.mask_embed)
    y, n_conceal, _ = counted(lambda: scn.conceal(a_np, zt * ~mk[:, None, :], mk))
    gate(y.shape == (1, 1, 24000) and bool(torch.isfinite(y).all())
         and n_conceal == expect(True, k1=8),
         f"plc_train: the trained head through StreamingConcealer: launches {n_conceal}")

    # the inpainting decoder: only the decoder copy trains
    before = {k: v.detach().clone() for k, v in
              list(bb.state_dict().items()) + [("head." + k, v) for k, v in
                                               head.state_dict().items()]}
    t0 = time.perf_counter()
    dh, n_ft, _ = counted(lambda: plc_train.finetune_inpaint_decoder(
        cfg, tcfg, pcfg, bbs, head, batches, val_batches, out_dir, seed=seed, epochs=1,
        log=lambda s: print(f"[plc_decft] {s}", flush=True)))
    ft_s = time.perf_counter() - t0
    after = dict(list(bb.state_dict().items()) + [("head." + k, v) for k, v in
                                                  head.state_dict().items()])
    others_equal = all(torch.equal(after[k], v) for k, v in before.items())
    dec_path = os.path.join(out_dir, "dec_plc.msgpack")
    dec = load_decoder(dec_path, cfg.dac).cuda()
    dec_moved = max(float((p - q).detach().abs().max()) for (_, p, _), (_, q, _) in
                    zip(decoder_leaves(dec), decoder_leaves(bb.decoder)))
    gate(others_equal and dec_moved > 0.0,
         f"plc_train: the fine-tune changed another leaf ({not others_equal}) or no decoder "
         f"leaf (largest change {dec_moved})")

    # dec_ft in the evaluator: the zero-fill floor as without, the concealed row not
    ev = os.path.join(TRAIN_DIR, "plc_eval")
    quiet = lambda *_: None                                      # noqa: E731
    plain_ev, n_ev, _ = counted(lambda: eval_plc_uniform(pm, va, os.path.join(ev, "stock"),
                                                         pcfg, log=quiet))
    ft_ev = eval_plc_uniform(pm, va, os.path.join(ev, "dec_ft"), pcfg, dec_ft=dec, log=quiet)
    zero_same = all(ft_ev[k] == plain_ev[k] for k in ("mean_psnr_masked_zero_db",
                                                      "mean_stsim_global_zero"))
    gate(zero_same and ft_ev["mean_psnr_masked_db"] != plain_ev["mean_psnr_masked_db"]
         and np.isfinite(ft_ev["dec_ft_gain_masked_db"]),
         f"plc_train: dec_ft in eval_plc_uniform: zero-fill equal {zero_same}, concealed "
         f"{ft_ev['mean_psnr_masked_db']} against {plain_ev['mean_psnr_masked_db']}")
    say("plc_train", weights=ctx["weights"], mode="uniform", batch=tcfg.batch,
        epochs=tcfg.epochs, latent_pretrain_epochs=1, plc=dataclasses.asdict(pcfg), **probes,
        launches_run=n_run, run_wall_s=run_s, files=files,
        hist={k: hist[k] for k in ("train", "val", "lat", "tmse", "val_masked_snr_db")},
        conceal_launches=n_conceal, decoder_ft_wall_s=ft_s, decoder_ft_launches=n_ft,
        decoder_ft_hist=dh, decoder_ft_largest_change=dec_moved,
        others_bit_equal=others_equal, eval_files=len(va), eval_launches=n_ev,
        eval_stock={k: plain_ev[k] for k in ("mean_psnr_masked_db", "mean_psnr_masked_zero_db",
                                             "plc_gain_masked_db")},
        eval_dec_ft={k: ft_ev[k] for k in ("mean_psnr_masked_db", "mean_psnr_masked_zero_db",
                                           "mean_psnr_masked_stockdec_db",
                                           "dec_ft_gain_masked_db")},
        wall_s=time.perf_counter() - t_phase)


PRETRAIN_DIR = os.path.join(REPO, "build", "chip_smoke_pretrain")
R5_COUNTS = os.path.join(ARTIFACTS, "r5", "vq_counts.msgpack")
PRETRAIN_STEPS, PRETRAIN_VAL = 3, 2


def pretrain_start(cfg: DacConfig, seed: int) -> tuple:
    """(the checkpoint both recipes resume from, what it is): r5's backbone
    with its usage counts beside it, or a seeded init written as a
    checkpoint (no counts: the loop warm-starts them at 100)."""
    if os.path.exists(R5[0]) and os.path.exists(R5_COUNTS):
        return R5[0], "artifacts/r5 backbone_best (trained) and its vq_counts"
    bb = dac.init_dac_(dac.DAC(cfg), torch.Generator().manual_seed(seed))
    path = os.path.join(PRETRAIN_DIR, "start", "backbone.msgpack")
    checkpoint.save_checkpoint(path, dac_tree(bb), 0)
    return path, f"random, seed {seed}"


def bad_grads(named, may_be_zero=lambda name: False) -> list:
    """Leaves whose gradient is missing, not finite or all zero (unless
    ``may_be_zero(name)``)."""
    return [n for n, p in named if p.grad is None or not bool(torch.isfinite(p.grad).all())
            or not (may_be_zero(n) or bool(p.grad.abs().sum() > 0))]


def output_bias(name: str) -> bool:
    """A discriminator's output bias: it shifts the real and the fake logits
    alike, so its hinge gradient, (fake logits above -1 - real logits below
    1) / count, is exactly 0 while every logit lies inside the margin, as at
    a fresh discriminator."""
    return name.endswith(".post.b")


def host_equal(tree, live) -> bool:
    live = checkpoint.to_host(live)
    return all(np.array_equal(tree_at(tree, p), tree_at(live, p))
               for p, _ in checkpoint.flatten(live))


def pretrain_probes(cfg, tcfg, gcfg, start: str, x: torch.Tensor, seed: int) -> dict:
    """The step functions of both recipes on one batch: launches, gradients,
    the eval step through K1 against the plain stacks, times, profile,
    memory, a checkpoint write."""
    sched = pb.warmup_cosine_lr(tcfg.lr, 100, 1, tcfg.lr_min_frac)
    counts = (torch.from_numpy(checkpoint.load_vq_counts(R5_COUNTS, (cfg.n_codebooks,
                                                                     cfg.codebook_size)))
              if start == R5[0] else torch.full((cfg.n_codebooks, cfg.codebook_size), 100.0))
    rm = load_dac(start, cfg).cuda()
    rs = pb.PretrainState(rm, pb.generator_optimizer(rm, tcfg, sched), vq_counts=counts.cuda())
    gm = load_dac(start, cfg).cuda()
    d = gan_losses.disc_init(gcfg, torch.Generator().manual_seed(seed + 1)).cuda()
    gs = pb.PretrainState(gm, pb.generator_optimizer(gm, tcfg, sched), d=d,
                          d_opt=pb.disc_optimizer(d, tcfg, gcfg))
    recon_step, eval_step = pb.make_pretrain_step(cfg, tcfg)
    gan_step, warmup_step, _ = pb.make_gan_pretrain_step(cfg, tcfg, gcfg)
    out = {}
    with fp32_exact():
        for name, st0, fn in (("recon", rs, recon_step), ("gan", gs, gan_step)):
            def once(st0=st0, fn=fn):           # with quantizer dropout and reseeding
                st = copy.deepcopy(st0)
                return [fn(st, x, seed + 1), *pretrain_state(st)]
            out.update({f"{name}_{k}": v for k, v in
                        same_step_twice(f"pretrain {name}", once).items()})
        torch.cuda.reset_peak_memory_stats()
        loss, n_recon, _ = counted(lambda: recon_step(rs, x, None))
        bad = bad_grads(rs.m.named_parameters())
        gate(not bad, f"pretrain: backbone gradients not finite or all zero after one "
                      f"reconstruction step: {bad}")
        total, n_eval, _ = counted(lambda: eval_step(rs.m, x))
        with plain_stacks():
            plain, n_plain, _ = counted(lambda: eval_step(rs.m, x))
        eval_rel = abs(float(total) - float(plain)) / abs(float(plain))
        gate(eval_rel <= 1e-6, f"pretrain: eval loss through K1 against the plain stacks "
                               f"{eval_rel:.3e}")
        d0 = [p.detach().clone() for p in d.parameters()]
        wl, n_warm, _ = counted(lambda: warmup_step(gs, x, None))
        gate(all(torch.equal(a, b) for a, b in zip(d0, d.parameters())),
             "pretrain: a warm-up step moved the discriminators")
        gl, n_gan, _ = counted(lambda: gan_step(gs, x, None))
        bad = bad_grads(d.named_parameters(), output_bias) + bad_grads(gs.m.named_parameters())
        gate(not bad, f"pretrain: gradients not finite or all zero after one GAN step: {bad}")
        out["disc_output_bias_grads"] = [float(p.grad) for n, p in d.named_parameters()
                                         if output_bias(n)]
        zero = expect(False)
        gate(n_recon == zero and n_warm == zero and n_gan == zero and n_plain == zero,
             f"pretrain: a train step launched a kernel: {n_recon} {n_warm} {n_gan} {n_plain}")
        gate(n_eval == expect(False, k1=8), f"pretrain: eval step launches {n_eval}")
        losses = [loss, total, wl, gl]
        gate(all(bool(torch.isfinite(v).all()) for v in losses),
             f"pretrain: probe losses not finite: {losses}")
        calls = {"recon_step": lambda: recon_step(rs, x, None),
                 "warmup_step": lambda: warmup_step(gs, x, None),
                 "gan_step": lambda: gan_step(gs, x, None),
                 "eval_step": lambda: eval_step(rs.m, x)}
        for name, fn in calls.items():
            out[f"{name}_ms"] = cuda_ms(fn, reps=3, warm=1)
        prof = profile_calls("pretrain", calls)
        out["max_memory_allocated_bytes"] = torch.cuda.max_memory_allocated()
    for name, p in prof.items():
        out[f"{name}_device_ms"] = p["device_ms"]
        out[f"{name}_busy_share"] = p["busy_share"]
    k1 = prof["eval_step"]["by_kind"].get("K1 resunit_stack", {"ms": 0.0})["ms"]
    out["eval_step_k1_share"] = k1 / prof["eval_step"]["device_ms"]
    out["recon_step_by_kind"] = prof["recon_step"]["by_kind"]
    path = os.path.join(PRETRAIN_DIR, "probe_write.msgpack")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    checkpoint.save_checkpoint(path, dac_tree(rs.m), 0)
    out["checkpoint_write_s"] = time.perf_counter() - t0
    out["checkpoint_bytes"] = os.path.getsize(path)
    os.remove(path)
    out.update(launches_recon_step=n_recon, launches_warmup_step=n_warm,
               launches_gan_step=n_gan, launches_eval_step=n_eval,
               eval_rel_err_k1_vs_plain=eval_rel, eval_bit_equal_k1_vs_plain=eval_rel == 0.0,
               probe_losses=[v.tolist() for v in losses])
    return out


def pretrain_run(cfg, tcfg, gcfg, start: str, stream, val_set, seed: int, name: str) -> dict:
    """One recipe's ``pretrain_backbone`` (resumed from ``start`` at epoch 1,
    ``PRETRAIN_STEPS`` steps an epoch), its launches and what its files
    hold against the live state at their epochs."""
    seen: dict = {}

    def on_epoch(ep, st):
        seen[ep] = {"model": checkpoint.snapshot(dac_tree(st.m)),
                    "counts": None if st.vq_counts is None else st.vq_counts.clone(),
                    "disc": None if st.d is None else checkpoint.snapshot(disc_tree(st.d)),
                    "t": time.perf_counter() - t0}

    waits: list = []

    def timed(batches):             # the host's wait for each batch
        for _ in range(PRETRAIN_STEPS):
            t = time.perf_counter()
            b = next(batches)
            waits.append(time.perf_counter() - t)
            yield b

    out_dir = os.path.join(PRETRAIN_DIR, name)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hist, n_run, _ = counted(lambda: pb.pretrain_backbone(
        cfg, tcfg, lambda ep: timed(stream), lambda: iter(val_set),
        out_dir, seed=seed, steps_per_epoch=PRETRAIN_STEPS, gan=gcfg, resume_from=start,
        start_epoch=1, on_epoch=on_epoch, log=lambda s: print(f"[pretrain] {s}", flush=True)))
    run_s = time.perf_counter() - t0
    want = dict(expect(False, k1=8 * PRETRAIN_VAL * tcfg.epochs))
    gate(n_run == want, f"pretrain {name}: run launches {n_run}, expected {want} "
                        "(K1 in the eval steps only)")
    gate(all(np.isfinite(hist["train"] + hist["val"])) and len(hist["train"]) == tcfg.epochs,
         f"pretrain {name}: hist {hist}")
    files = {}
    for fname in ("last", "best"):
        tree, epoch, fhist = checkpoint.load_checkpoint(os.path.join(out_dir, f"{fname}.msgpack"),
                                                        dac_template(cfg))
        same = host_equal(tree, seen[epoch]["model"])
        files[fname] = {"epoch": epoch, "equal_live": same}
        gate(same and set(fhist) == {"train", "val"},
             f"pretrain {name}: {fname}.msgpack (epoch {epoch}) differs from the live backbone "
             f"or its hist keys {sorted(fhist)}")
    if gcfg is None:
        shape = (cfg.n_codebooks, cfg.codebook_size)
        tree, epoch, _ = checkpoint.load_checkpoint(os.path.join(out_dir, "vq_counts.msgpack"),
                                                    {(): shape})
        same = np.array_equal(tree, seen[epoch]["counts"].cpu().numpy())
        files["vq_counts"] = {"epoch": epoch, "equal_live": same}
        gate(same, f"pretrain {name}: vq_counts.msgpack differs from the live counts")
    else:
        tree, epoch, _ = checkpoint.load_checkpoint(os.path.join(out_dir, "disc_last.msgpack"),
                                                    disc_template(gcfg))
        same = host_equal(tree, seen[epoch]["disc"])
        files["disc_last"] = {"epoch": epoch, "equal_live": same}
        gate(same, f"pretrain {name}: disc_last.msgpack differs from the live discriminators")
        d0 = checkpoint.to_host(disc_tree(gan_losses.disc_init(
            gcfg, torch.Generator().manual_seed(seed + 1))))
        frozen = host_equal(d0, seen[1]["disc"])
        moved = not host_equal(d0, seen[2]["disc"])
        files["disc_frozen_epoch1_moved_epoch2"] = frozen and moved
        gate(frozen and moved, f"pretrain {name}: discriminators frozen in epoch 1 {frozen}, "
                               f"moved in epoch 2 {moved}")
    with open(os.path.join(out_dir, "hist.json")) as f:
        gate(set(json.load(f)) == {"train", "val"}, f"pretrain {name}: hist.json keys")
    steps = tcfg.epochs * PRETRAIN_STEPS
    return {"hist": hist, "launches_run": n_run, "run_wall_s": run_s,
            "steps_per_s": steps / run_s, "epoch_end_s": [seen[e]["t"] for e in sorted(seen)],
            "data_wait_ms_per_step": 1e3 * float(np.mean(waits)),
            "data_wait_ms_max": 1e3 * float(np.max(waits)),
            "files": files, "out_dir": out_dir}


def pretrain_phase(seed: int) -> None:
    """Backbone pretraining at full width, both recipes; see the module
    docstring (phase 17)."""
    t_phase = time.perf_counter()
    cfg = DacConfig()
    tcfg = TrainConfig(epochs=2, batch=8, seg_sec=1.0, lr=2e-4, grad_clip=3.0,
                       adam_b1=0.8, adam_b2=0.99)
    shutil.rmtree(PRETRAIN_DIR, ignore_errors=True)
    start, weights = pretrain_start(cfg, seed)
    stream = stream_pretrain_batches(tcfg.batch, seg=tcfg.seg, sr=cfg.sample_rate, seed=seed,
                                     wire_i16=True)
    val_set = list(islice(stream_pretrain_batches(
        tcfg.batch, seg=tcfg.seg, sr=cfg.sample_rate, seed=seed + 10_000, prefetch=1,
        wire_i16=True), PRETRAIN_VAL))
    x = torch.from_numpy(next(stream)).cuda()
    probes = pretrain_probes(cfg, tcfg, GanConfig(), start, x, seed)
    runs = {"recon": pretrain_run(cfg, tcfg, None, start, stream, val_set, seed, "recon"),
            "gan": pretrain_run(cfg, tcfg, GanConfig(start_epoch=2), start, stream, val_set,
                                seed, "gan")}
    # the hand-off: the pretrained backbone serves a bf16 encode and decode
    bb = load_dac(os.path.join(runs["gan"]["out_dir"], "best.msgpack"), cfg).cuda()
    xb = wire.decode_wave(torch.from_numpy(val_set[0][:1]).cuda()).to(torch.bfloat16)
    (zq, codes), n_enc, _ = counted(lambda: dac.encode_quantized(bb, cfg, xb))
    y, n_dec, _ = counted(lambda: dac.decode(bb, cfg, zq))
    want = expect(True, k1=4)
    gate(n_enc == want and n_dec == want and y.shape == (1, 1, tcfg.seg)
         and bool(torch.isfinite(y).all()) and codes.shape == (1, 75, cfg.n_codebooks),
         f"pretrain: reloaded backbone's bf16 encode / decode: launches {n_enc} / {n_dec}, "
         f"output {tuple(y.shape)} finite {bool(torch.isfinite(y).all())}")
    say("pretrain", weights=weights, batch=tcfg.batch, seg=tcfg.seg, epochs=tcfg.epochs,
        steps_per_epoch=PRETRAIN_STEPS, val_batches=PRETRAIN_VAL, **probes,
        runs={k: {kk: vv for kk, vv in v.items() if kk != "out_dir"} for k, v in runs.items()},
        handoff_launches={"encode": n_enc, "decode": n_dec},
        wall_s=time.perf_counter() - t_phase)


# ---------------------------------------------------------------- 18-19: demo, evidence

DEMO_DIR = os.path.join(REPO, "build", "chip_smoke_demo")
EVIDENCE_DIR = os.path.join(REPO, "build", "chip_smoke_evidence")
# the demo at full width, its depth cut: 12 two-second pairs (10 train, 2
# held out), one pretraining and one head epoch, two PLC epochs of which the
# first is the latent regression, batch 4, two sweep runs
DEMO_FLAGS = ["--pairs", "12", "--dur-sec", "2", "--pretrain-epochs", "1",
              "--codec-epochs", "1", "--plc-epochs", "2", "--plc-latent-epochs", "1",
              "--batch", "4", "--books-grid", "2,8", "--embed-grid", "128", "--cached-heads",
              "--plc-category", "--plc-eval-files", "2", "--seed", "7"]
K1_FP32 = 6            # K1 launches of one fp32 stack of 3 units
# K1 launches a call, by what the call is (the wrappers' counts; a stack of
# the encoder or the decoder is K1_FP32 launches in fp32)
K1_PER_CALL = {
    "pretrain_train_step": 0, "pretrain_eval_step": 8 * K1_FP32,
    "cache_build_batch": 8 * K1_FP32,
    "sweep_train_epoch": 0, "sweep_eval_epoch": 0,
    "plc_train_step": 0, "plc_eval_step": 0, "plc_latent_step": 0,
    "backbone_forward": 8 * K1_FP32, "proposed_forward": 12 * K1_FP32,
    "example": 12 * K1_FP32, "plc_file": 20 * K1_FP32,
}


class Tee:
    """Standard output copied into a buffer (the demo's printed lines)."""

    def __init__(self, out):
        self.out, self.lines = out, []

    def write(self, text):
        self.lines.append(text)
        return self.out.write(text)

    def flush(self):
        self.out.flush()


def k1_now() -> int:
    return resunit.launches


def on_card(x, seen=None) -> list:
    """What in ``x`` (modules, tensors, and what they are held in) lies off
    the card: -> descriptions."""
    seen = set() if seen is None else seen
    if id(x) in seen:
        return []
    seen.add(id(x))
    if isinstance(x, torch.nn.Module):
        return [f"{type(x).__name__}.{n}" for n, t in
                list(x.named_parameters()) + list(x.named_buffers()) if t.device.type != "cuda"]
    if isinstance(x, torch.Tensor):
        return [] if x.device.type == "cuda" else [f"tensor {tuple(x.shape)}"]
    if isinstance(x, dict):
        return [b for v in x.values() for b in on_card(v, seen)]
    if isinstance(x, (list, tuple)):
        return [b for v in x for b in on_card(v, seen)]
    if type(x).__name__.endswith("State"):
        return [b for v in vars(x).values() for b in on_card(v, seen)]
    return []


class DemoProbe:
    """K1 launches and devices of the demo's calls. Each watched function
    records, per call, the K1 launches between its start and its end (the
    difference of the counter, which is set to 0 once before the demo) and
    what of its arguments lies off the card after it; each stage, its
    launches, wall seconds and peak memory."""

    def __init__(self):
        self.calls: dict = {}
        self.stages: dict = {}
        self.off_card: list = []
        self.patches: list = []
        self.k1_events: list = []

    def time_stacks(self) -> None:
        """CUDA events around every stack the model sends to K1's wrapper
        (``dac.resunit_stack``) outside a CUDA-graph capture: their sum over
        a stage is K1's time there (the latency map's graph replays are not
        in it)."""
        fn = dac.resunit_stack
        self.patches.append((dac, "resunit_stack", fn))

        def timed(*a, **kw):
            if torch.cuda.is_current_stream_capturing():
                return fn(*a, **kw)
            ev = (torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
            ev[0].record()
            out = fn(*a, **kw)
            ev[1].record()
            self.k1_events.append(ev)
            return out
        dac.resunit_stack = timed

    def record(self, kind: str, fn, per: int = 1):
        def wrapped(*a, **kw):
            k0 = k1_now()
            out = fn(*a, **kw)
            torch.cuda.synchronize()
            self.calls.setdefault(kind, []).append((k1_now() - k0) / per)
            self.off_card += [f"{kind}: {b}" for b in on_card((a, kw))]
            return out
        return wrapped

    def watch(self, mod, name: str, kind: str, per=None) -> None:
        fn = getattr(mod, name)
        self.patches.append((mod, name, fn))
        if per is None:
            setattr(mod, name, self.record(kind, fn))
        else:       # per(args, kwargs) -> the count of units of a call
            def wrapped(*a, **kw):
                return self.record(kind, fn, per(a, kw))(*a, **kw)
            setattr(mod, name, wrapped)

    def watch_factory(self, mod, name: str, kinds: tuple) -> None:
        """``mod.name`` returns step functions: each is recorded under its kind."""
        factory = getattr(mod, name)
        self.patches.append((mod, name, factory))

        def wrapped(*a, **kw):
            return tuple(self.record(k, f) for k, f in zip(kinds, factory(*a, **kw)))
        setattr(mod, name, wrapped)

    def watch_batches(self, mod, name: str, kind: str) -> None:
        """``mod.name(backbones, cfg, batches, ...)`` consumes an iterable of
        batches: the launches between two batches are the first's."""
        fn = getattr(mod, name)
        self.patches.append((mod, name, fn))
        probe = self

        def per_batch(batches):
            k0 = None
            for b in batches:
                if k0 is not None:
                    torch.cuda.synchronize()
                    probe.calls.setdefault(kind, []).append(k1_now() - k0)
                k0 = k1_now()
                yield b
            if k0 is not None:
                torch.cuda.synchronize()
                probe.calls.setdefault(kind, []).append(k1_now() - k0)

        def wrapped(backbones, cfg, batches, *a, **kw):
            out = fn(backbones, cfg, per_batch(batches), *a, **kw)
            self.off_card += [f"{kind}: {b}" for b in on_card((backbones, out))]
            return out
        setattr(mod, name, wrapped)

    def restore(self) -> None:
        for mod, name, fn in reversed(self.patches):
            setattr(mod, name, fn)
        self.patches = []

    @contextlib.contextmanager
    def stage(self, name: str):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        k0, t0 = k1_now(), time.perf_counter()
        self.k1_events = []
        yield
        torch.cuda.synchronize()
        self.stages[name] = {"wall_s": time.perf_counter() - t0, "k1_launches": k1_now() - k0,
                             "k1_stack_s": sum(a.elapsed_time(b) for a, b in self.k1_events)
                             / 1e3, "peak_gb": torch.cuda.max_memory_allocated() / 1e9}


def demo_probe() -> DemoProbe:
    """A probe on every call of the demo that launches, or must not launch,
    K1."""
    pr = DemoProbe()
    pr.watch_factory(pb, "make_pretrain_step", ("pretrain_train_step", "pretrain_eval_step"))
    pr.watch_factory(train_loop, "make_cached_epoch_fns",
                     ("sweep_train_epoch", "sweep_eval_epoch"))
    pr.watch_factory(plc_train, "make_plc_train_step",
                     ("plc_train_step", "plc_eval_step", "plc_latent_step"))
    pr.watch_batches(latent_cache, "build_latent_cache", "cache_build_batch")
    # a backbone-evaluator call: one forward at each depth and a 4-stack probe
    # of the token rate; the pairs fit one forward batch
    pr.watch(dac_baseline, "eval_backbone_codec", "backbone_call")
    pr.watch(proposed, "evaluate_proposed_model", "proposed_forward")
    pr.watch(plots, "example_signals", "example",
             per=lambda a, kw: min(len(a[3]), kw.get("num_examples", 10)))
    pr.watch(eval_uniform, "eval_plc_file", "plc_file")
    pr.watch(eval_categories, "eval_plc_file", "plc_file")
    pr.watch(demo_eval_only, "measure", "latency_map")
    pr.time_stacks()
    return pr


def key_tree(x):
    """The keys of nested dicts; a list is the tree of its first row, all
    rows alike (checked by ``same_rows``)."""
    if isinstance(x, dict):
        return {k: key_tree(v) for k, v in x.items()}
    if isinstance(x, list):
        return [key_tree(x[0])] if x else []
    return None


def same_rows(x) -> bool:
    if isinstance(x, dict):
        return all(same_rows(v) for v in x.values())
    if isinstance(x, list):
        return all(key_tree(v) == key_tree(x[0]) and same_rows(v) for v in x)
    return True


def demo_checkpoints(root: str, cfg: CodecConfig, runs: list, pretrained: bool) -> dict:
    """Every checkpoint of a demo root read back strictly through
    ``convert`` (and ``train/checkpoint.py`` for the usage counts): -> {path:
    "ok" or the error}."""
    out = {}

    def read(rel, fn):
        try:
            fn(os.path.join(root, rel))
            out[rel] = "ok"
        except Exception as e:            # reported, and gated below
            out[rel] = f"{type(e).__name__}: {e}"

    bb_rel = os.path.join("backbone", "best.msgpack")
    read(bb_rel, lambda p: load_dac(p, cfg.dac))
    if pretrained:
        read(os.path.join("backbone", "last.msgpack"), lambda p: load_dac(p, cfg.dac))
        read(os.path.join("backbone", "vq_counts.msgpack"), lambda p: checkpoint.load_vq_counts(
            p, (cfg.dac.n_codebooks, cfg.dac.codebook_size)))
    bb = load_dac(os.path.join(root, bb_rel), cfg.dac)
    for run in runs:
        books, embed = (int(x) for x in re.match(r"rvqB(\d+)_K(\d+)$", run).groups())
        for f in ("best.msgpack", "last.msgpack"):
            read(os.path.join("sweep", run, f), lambda p: convert.codec_from_backbones(
                bb, bb, p, cfg.with_rvq(books, embed)))
    for mode in ("plc_uniform", "plc_category"):
        n_layers = plc_config_from_meta(os.path.join(root, mode)).n_layers
        for f in ("best.msgpack", "last.msgpack"):
            read(os.path.join(mode, f), lambda p: load_plc_head(p, cfg, n_layers))
    return out


def gate_demo_launches(name: str, probe: DemoProbe, want_calls: dict) -> dict:
    """Each recorded call's K1 launches against ``K1_PER_CALL``, and the
    count of calls of each kind against ``want_calls``; -> {kind: [per-call
    launches]}."""
    per = {k: sorted(set(v)) for k, v in probe.calls.items()}
    for kind, launches in per.items():
        if kind == "latency_map":
            continue
        if kind == "backbone_call":
            want = [len(NQ) * K1_PER_CALL["backbone_forward"] + 4 * K1_FP32]
        else:
            want = [K1_PER_CALL[kind]]
        gate(launches == want, f"{name}: K1 launches of a {kind} {launches}, expected {want}")
    counts = {k: len(v) for k, v in probe.calls.items()}
    gate(all(counts.get(k, 0) == n for k, n in want_calls.items()),
         f"{name}: calls {counts}, expected {want_calls}")
    gate(not probe.off_card, f"{name}: off the card: {probe.off_card[:8]}")
    return per


def demo_phase() -> None:
    """The port's end-to-end demo at full width on the card; see the module
    docstring (phase 18)."""
    t_phase = time.perf_counter()
    cfg = CodecConfig()
    shutil.rmtree(DEMO_DIR, ignore_errors=True)
    reused = os.path.exists(R5[0])
    if reused:      # r5's backbone as the demo's: stage 2 reuses it
        os.makedirs(os.path.join(DEMO_DIR, "backbone"))
        shutil.copy(R5[0], os.path.join(DEMO_DIR, "backbone", "best.msgpack"))
    figures = artifacts.have_matplotlib()
    probe = demo_probe()
    tee = Tee(sys.stdout)
    resunit.launches = 0
    try:
        with contextlib.redirect_stdout(tee):
            out = demo_end_to_end.main(["--root", DEMO_DIR] + DEMO_FLAGS, stage=probe.stage)
    finally:
        probe.restore()
    printed = "".join(tee.lines)
    combined, examples = out["combined"], out["examples"]
    runs = [r["run"] for r in combined["proposed_runs"]]
    n_eval, n_plc = len(out["eval_pairs"]), len(out["plc_eval_pairs"])

    # files, checkpoints, the JSON's keys, rates and metrics
    missing = [os.path.relpath(p, DEMO_DIR) for p in demo_end_to_end.contract_files(
        DEMO_DIR, runs, len(examples), pretrained=not reused, figures=figures)
        if not os.path.exists(p)]
    gate(not missing, f"demo: contract files missing: {missing}")
    if not figures:
        gate("curves.png not drawn" in printed and "stsim_vs_kbps.png" in printed,
             "demo: no 'not drawn' line for the figures without matplotlib")
    ckpts = demo_checkpoints(DEMO_DIR, cfg, runs, not reused)
    gate(all(v == "ok" for v in ckpts.values()),
         f"demo: checkpoints that do not read back: {ckpts}")
    with open(os.path.join(EVIDENCE, "sweep", "eval_vs_backbone", demo_eval_only.OUT_JSON)) as f:
        committed = json.load(f)
    with open(os.path.join(DEMO_DIR, "sweep", "eval_vs_backbone", demo_eval_only.OUT_JSON)) as f:
        written = json.load(f)
    gate(key_tree(written) == key_tree(committed) and same_rows(written),
         "demo: the combined JSON's keys differ from the committed evidence's")
    rate_gaps = [abs(r["kbps"] - cfg.with_rvq(r["books"], r["embed"]).kbps())
                 for r in written["proposed_runs"]] + [
        abs(r["kbps"] - cfg.dac.tokens_per_sec * int(q) * np.log2(cfg.dac.codebook_size) / 1e3)
        for q, r in written["dac_24khz"].items()]
    gate(max(rate_gaps) <= 1e-9, f"demo: rates off their nominal rates by {rate_gaps}")
    rows = (list(written["dac_24khz"].values()) + written["proposed_runs"]
            + written["vc_pwq_runs"])
    values = [r[k] for r in rows for k in r if k.endswith(("_mean", "_ci95"))]
    gate(len(written["vc_pwq_runs"]) == len(EvalConfig().vc_b_list)
         and all(np.isfinite(v) for v in values), "demo: a metric is not finite, or VC rows")
    # (the stock-decoder columns are NaN without an inpainting decoder)
    plc_vals = {f"{name}.{k}": v for name, summ in [("uniform", out["plc_uniform"])] + [
        (c, out["plc_category"][c]) for c in masks.CATEGORIES] for k, v in summ.items()
        if isinstance(v, float) and "stockdec" not in k and "dec_ft" not in k}
    gate(all(np.isfinite(v) for v in plc_vals.values()),
         f"demo: a PLC summary value is not finite: {plc_vals}")

    # K1 per call of each kind, and how many calls
    want_calls = {"pretrain_eval_step": 0 if reused else 1,
                  "pretrain_train_step": 0 if reused else 2,
                  "cache_build_batch": 2, "sweep_train_epoch": len(runs),
                  "sweep_eval_epoch": len(runs), "backbone_call": 1,
                  "proposed_forward": len(runs), "example": 1,
                  "plc_file": n_plc * (1 + len(masks.CATEGORIES))}
    per_call = gate_demo_launches("demo", probe, want_calls)

    # the examples' PSNR against the evaluator's for each file alone
    best = plots.best_by_stsim(combined["proposed_runs"])
    peak = combined["config"]["peak_global_raw"]
    bb = load_dac(os.path.join(DEMO_DIR, "backbone", "best.msgpack"), cfg.dac).cuda()
    m = convert.codec_from_backbones(bb, bb, os.path.join(best["path"], "best.msgpack"),
                                     cfg.with_rvq(best["books"], best["embed"]))
    lat = {"enc_ms": 0.0, "dec_ms": 0.0, "enc_p50_ms": 0.0, "enc_p95_ms": 0.0,
           "dec_p50_ms": 0.0, "dec_p95_ms": 0.0}
    gaps = [abs(ex["psnr_db"] - proposed.evaluate_proposed_model(
        m, [pair], peak, books_use=best["books"], latency=lat)["psnr_mean"])
        for ex, pair in zip(examples, out["eval_pairs"])]
    mean_gap = abs(float(np.mean([ex["psnr_db"] for ex in examples])) - best["psnr_mean"])
    gate(len(gaps) == n_eval and max(gaps) <= 1e-3 and mean_gap <= 1e-3,
         f"demo: example PSNR off the evaluator's by {gaps} (mean {mean_gap})")
    say("demo", weights=("artifacts/r5 backbone (reused)" if reused
                         else "pretrained in the demo from --seed 7"),
        flags=DEMO_FLAGS, figures_drawn=figures, stages=probe.stages,
        k1_per_call=per_call, calls={k: len(v) for k, v in probe.calls.items()},
        checkpoints=len(ckpts), runs=runs, examples=len(examples),
        example_psnr_gap_db=max(gaps), psnr_mean={r["run"]: r["psnr_mean"]
                                                  for r in written["proposed_runs"]},
        wall_s=time.perf_counter() - t_phase)


def worst_gap(committed, fresh) -> dict:
    """The largest |committed - fresh| of each tolerance class."""
    out = {"psnr_db": 0.0, "stsim": 0.0, "kbps": 0.0}

    def walk(c, f, key=""):
        if isinstance(c, dict):
            for k in c:
                if k in f:
                    walk(c[k], f[k], k)
        elif isinstance(c, list):
            for a, b in zip(c, f):
                walk(a, b, key)
        elif isinstance(c, float) and np.isfinite(c) and np.isfinite(f):
            cls = "kbps" if "kbps" in key else "stsim" if "stsim" in key else "psnr_db"
            out[cls] = max(out[cls], abs(c - f))
    walk(committed, fresh)
    return out


def evidence_phase() -> None:
    """``evidence_tiny check`` on the card; see the module docstring (phase
    19)."""
    t_phase = time.perf_counter()
    probe = demo_probe()
    resunit.launches = 0
    try:
        res = evidence_tiny.check(EVIDENCE_DIR, stage=probe.stage)
    finally:
        probe.restore()
    gate(not res["mismatches"], f"evidence: off MANIFEST.json: {res['mismatches']}")
    gate(not res["corpus"], f"evidence: corpus WAVs not the committed bytes: {res['corpus']}")
    n_plc = len(res["demo"]["plc_eval_pairs"])
    per_call = gate_demo_launches("evidence", probe, {
        "pretrain_train_step": 0, "cache_build_batch": 2, "sweep_train_epoch": 0,
        "plc_train_step": 0, "plc_latent_step": 0, "backbone_call": 1,
        "proposed_forward": 2, "plc_file": n_plc * (1 + len(masks.CATEGORIES))})
    say("evidence", mismatches=len(res["mismatches"]), corpus_mismatches=len(res["corpus"]),
        max_deviation_from_manifest=worst_gap(res["committed"], res["fresh"]),
        tolerances={"psnr_db": evidence_tiny.TOL_DB, "stsim": evidence_tiny.TOL_STSIM,
                    "kbps": evidence_tiny.TOL_KBPS},
        stages=probe.stages, k1_per_call=per_call, wall_s=time.perf_counter() - t_phase)


# ---------------------------------------------------------------- 20-22: mesh, dac_import, tooling

MESH_DIR = os.path.join(REPO, "build", "chip_smoke_mesh")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def head_gap(a: torch.nn.Module, b: torch.nn.Module) -> dict:
    """Two heads after one step from the same start: whether every leaf and
    buffer is bit-equal, and the largest absolute gap (reported)."""
    pairs = list(zip(a.state_dict().values(), b.state_dict().values()))
    return {"bit_equal": all(torch.equal(x, y) for x, y in pairs),
            "max_abs_gap": max(float((x.float() - y.float()).abs().max()) for x, y in pairs)}


def same_step_twice(name: str, run) -> dict:
    """F6: ``run()`` takes one step from one start (fresh state, one batch,
    one seed) and returns the tensors it leaves (metrics, parameters,
    optimizer and EMA state); run twice they must be bit-equal (gated)."""
    first, second = run(), run()
    off = unequal(first, second)
    ok = len(first) == len(second) and not off
    gate(ok, f"{name}: the same step twice from one start differs in {len(off)} of "
         f"{len(first)} tensors")
    return {"same_step_twice_bit_equal": ok, "same_step_twice_tensors": len(first)}


def pretrain_state(st: pb.PretrainState) -> list:
    """What a pretraining step leaves: the backbone, its optimizer, the usage
    counts, the discriminators and theirs."""
    out = [*st.m.parameters(), *opt_state(st.opt)]
    if st.vq_counts is not None:
        out.append(st.vq_counts)
    if st.d is not None:
        out += [*st.d.parameters(), *opt_state(st.d_opt)]
    return out


def mesh_phase(m: allpred_ar.CodecModules, a, tc, ctx: dict, seed: int) -> None:
    """The data-parallel mesh at world size 1 on NCCL; see the module
    docstring (phase 20)."""
    t_phase = time.perf_counter()
    world = pmesh.distributed_init(f"tcp://localhost:{free_port()}", 1, 0,
                                   device=torch.device("cuda", 0))
    mesh = pmesh.create_mesh()
    gate(world == 1 and mesh.backend == "nccl" and dist.get_backend() == "nccl"
         and mesh.device.type == "cuda", f"mesh: backend {mesh.backend}, device {mesh.device}")
    out: dict = {"backend": mesh.backend, "shape": mesh.shape}
    try:
        # serving: the bf16 bytes round trip, meshless and meshed
        sc0 = StreamingCodec(m, batch=1, frame_sec=1.0)
        sc1 = StreamingCodec(m, batch=1, frame_sec=1.0, mesh=mesh)
        streams0, n0, _ = counted(lambda: sc0.encode_to_bytes(a, tc))
        streams1, n1, _ = counted(lambda: sc1.encode_to_bytes(a, tc))
        y1, n_dec, _ = counted(lambda: sc1.decode_from_bytes(a, streams1))
        y0 = sc0.decode_from_bytes(a, streams0)
        codes_eq = torch.equal(sc0.encode(a, tc)[1], sc1.encode(a, tc)[1])
        want = expect(True, k1=8)
        gate(n1 == want and n_dec == want and n0 == want,
             f"mesh: launches meshed encode {n1} / decode {n_dec}, meshless {n0}; want {want}")
        gate(codes_eq and streams0 == streams1 and torch.equal(y0, y1),
             f"mesh: meshed serving differs: codes equal {codes_eq}, bytes equal "
             f"{streams0 == streams1}, waveform equal {torch.equal(y0, y1)}")
        out["serving"] = {"launches_encode": n1, "launches_decode": n_dec,
                          "codes_equal": codes_eq, "bytes_equal": streams0 == streams1,
                          "waveform_equal": torch.equal(y0, y1),
                          "encode_ms_meshless": cuda_ms(lambda: sc0.encode(a, tc), reps=5),
                          "encode_ms_mesh": cuda_ms(lambda: sc1.encode(a, tc), reps=5)}

        # one batch-6 head train step, meshless and meshed, from the same head
        cfg, tcfg, bb = ctx["cfg"], ctx["tcfg"], ctx["bb"]
        ds = SegmentDataset(ctx["split"][0], sr=tcfg.target_sr, seg=tcfg.seg, seed=tcfg.seed)
        batch_np = next(batch_iterator(ds, tcfg.batch, seed=seed))
        xa, xt = (torch.from_numpy(x).cuda() for x in batch_np)
        sa, st = pmesh.shard_batch(mesh, batch_np)

        def fresh():
            head = allpred_ar.head_init(cfg, torch.Generator().manual_seed(seed)).cuda()
            return train_loop.TrainState(allpred_ar.codec_of(bb, bb, head, cfg),
                                         train_loop.AdamW(train_loop.adamw_params(head), tcfg, 3))
        with fp32_exact():
            step0, _ = train_loop.make_step_fns(cfg, tcfg)
            step1, _ = train_loop.make_step_fns(cfg, tcfg, mesh)
            s0, s0b, s1 = fresh(), fresh(), fresh()
            met0 = step0(s0, xa, xt, seed + 1, do_ema=True)
            met0b = step0(s0b, xa, xt, seed + 1, do_ema=True)
            met1, n_step, _ = counted(lambda: step1(s1, sa, st, seed + 1, do_ema=True))
            train_eq = torch.equal(met0, met1)
            gap, again = head_gap(s1.head, s0.head), head_gap(s0b.head, s0.head)
            gate(train_eq, f"mesh: the meshed train step's metrics differ: "
                 f"{met0.tolist()} / {met1.tolist()}")
            gate(gap["bit_equal"], f"mesh: the meshed step's head is not the meshless "
                 f"one's bit for bit: {gap}")
            gate(again["bit_equal"] and torch.equal(met0, met0b),
                 f"mesh: two meshless steps from one start differ: {again}")
            gate(n_step == expect(False, k1=8), f"mesh: launches a meshed train step {n_step}")
            prof = profile_calls("mesh_train_step", {
                "meshless": lambda: step0(s0, xa, xt, seed + 1, True),
                "mesh": lambda: step1(s1, sa, st, seed + 1, True)})
            out["train_step"] = {"batch": tcfg.batch, "loss": float(met1[0]),
                                 "metrics_bit_equal": train_eq, "head_vs_meshless": gap,
                                 "head_meshless_vs_meshless_again": again,
                                 "metrics_meshless_again_bit_equal": torch.equal(met0, met0b),
                                 "launches": n_step,
                                 "device_ms_meshless": prof["meshless"]["device_ms"],
                                 "device_ms_mesh": prof["mesh"]["device_ms"]}

            # one pretraining eval step on a batch of 8 through the backbone
            dcfg = cfg.dac
            x = next(stream_pretrain_batches(8, seg=24000, sr=dcfg.sample_rate, seed=seed,
                                             wire_i16=True))
            _, ev0 = pb.make_pretrain_step(dcfg, tcfg)
            _, ev1 = pb.make_pretrain_step(dcfg, tcfg, mesh=mesh)
            v0 = ev0(bb, torch.from_numpy(x).cuda())
            v1, n_ev, _ = counted(lambda: ev1(bb, pmesh.shard_batch(mesh, x)))
            gate(torch.equal(v0, v1), f"mesh: pretraining eval loss {float(v1)} != "
                 f"meshless {float(v0)}")
            gate(n_ev == expect(False, k1=8), f"mesh: launches a meshed eval step {n_ev}")
            out["pretrain_eval_step"] = {"batch": 8, "loss": float(v1),
                                         "bit_equal": torch.equal(v0, v1), "launches": n_ev}
    finally:
        dist.destroy_process_group()
    say("mesh", **out, wall_s=time.perf_counter() - t_phase)


DAC_IMPORT_DIR = os.path.join(REPO, "build", "chip_smoke_dac_import")


def descript_state_dict(m: dac.DAC) -> dict:
    """``m`` as a descript-audio-codec state dict: weight-normalised
    convolutions (``weight_v`` the weight, ``weight_g = ||v||`` per dim-0
    row), the up-convolutions in ``[C_in, C_out, k]``, the quantizer's 1x1
    projections as convolutions with their biases, Snake alphas [1, C, 1]."""
    sd = {}

    def conv(name, mod, weight=None):
        v = (mod.weight if weight is None else weight).detach().float().cpu()
        sd[name + ".weight_v"] = v
        # ||v|| summed as the importer sums it, so that g * v / ||v|| is v to an ulp
        sd[name + ".weight_g"] = torch.from_numpy(
            np.sqrt((v.numpy() ** 2).sum(axis=(1, 2), keepdims=True)))
        if weight is None:
            sd[name + ".bias"] = mod.bias.detach().float().cpu()

    def snake(name, s):
        sd[name + ".alpha"] = s.alpha.detach().float().cpu().reshape(1, -1, 1)

    def unit(name, u):
        snake(f"{name}.block.0", u.snake1)
        conv(f"{name}.block.1", u.conv1)
        snake(f"{name}.block.2", u.snake2)
        conv(f"{name}.block.3", u.conv2)

    enc, dec, q = m.encoder, m.decoder, m.quantizer
    conv("encoder.block.0", enc.in_conv)
    for i, b in enumerate(enc.blocks, start=1):
        for j, u in enumerate(b.units):
            unit(f"encoder.block.{i}.block.{j}", u)
        snake(f"encoder.block.{i}.block.3", b.snake)
        conv(f"encoder.block.{i}.block.4", b.down)
    snake(f"encoder.block.{len(enc.blocks) + 1}", enc.out_snake)
    conv(f"encoder.block.{len(enc.blocks) + 2}", enc.out_conv)
    conv("decoder.model.0", dec.in_conv)
    for i, b in enumerate(dec.blocks, start=1):
        snake(f"decoder.model.{i}.block.0", b.snake)
        conv(f"decoder.model.{i}.block.1", b.up)          # already [C_in, C_out, k]
        for j, u in zip((2, 3, 4), b.units):
            unit(f"decoder.model.{i}.block.{j}", u)
    snake(f"decoder.model.{len(dec.blocks) + 1}", dec.out_snake)
    conv(f"decoder.model.{len(dec.blocks) + 2}", dec.out_conv)
    for i in range(q.codebooks.shape[0]):
        p = f"quantizer.quantizers.{i}"
        conv(f"{p}.in_proj", None, q.in_proj[i].T[:, :, None])
        sd[f"{p}.in_proj.bias"] = q.in_bias[i].detach().float().cpu()
        conv(f"{p}.out_proj", None, q.out_proj[i].T[:, :, None])
        sd[f"{p}.out_proj.bias"] = q.out_bias[i].detach().float().cpu()
        sd[f"{p}.codebook.weight"] = q.codebooks[i].detach().float().cpu()
    return sd


def dac_import_phase(seed: int, a) -> None:
    """The descript weight import at full width; see the module docstring
    (phase 21)."""
    t_phase = time.perf_counter()
    cfg = DacConfig()
    src = dac.init_dac_(dac.DAC(cfg), torch.Generator().manual_seed(seed + 21))
    shutil.rmtree(DAC_IMPORT_DIR, ignore_errors=True)
    os.makedirs(DAC_IMPORT_DIR)
    path = os.path.join(DAC_IMPORT_DIR, "dac_descript.pth")
    sd = descript_state_dict(src)
    torch.save({"state_dict": sd, "metadata": {"kwargs": {"sample_rate": cfg.sample_rate}}},
               path)
    t0 = time.perf_counter()
    got = dac_import.load_torch_dac(path, cfg)
    load_s = time.perf_counter() - t0
    # the weights through g * v / ||v||: each within an ulp of the source's
    w_err = max(float((x - y).abs().max() / y.abs().max().clamp_min(1e-30))
                for x, y in zip(got.state_dict().values(), src.state_dict().values()))
    src, got = src.cuda().requires_grad_(False), got.cuda().requires_grad_(False)
    x = torch.from_numpy(a).cuda()
    res = {}
    for name, dt in (("fp32", torch.float32), ("bf16", torch.bfloat16)):
        (_, c_src), n_src, _ = counted(lambda: dac.encode_quantized(src, cfg, x.to(dt)))
        (_, c_got), n_got, _ = counted(lambda: dac.encode_quantized(got, cfg, x.to(dt)))
        res[name] = {"codes_equal": torch.equal(c_src, c_got),
                     "code_agreement": float((c_src == c_got).float().mean()),
                     "launches": n_got}
        want = expect(dt == torch.bfloat16, k1=4)
        gate(n_src == want and n_got == want, f"dac_import: {name} launches {n_got}, want {want}")
    gate(res["fp32"]["codes_equal"], "dac_import: the imported backbone's fp32 codes differ "
         f"from the source's ({res['fp32']['code_agreement']:.4f} agree)")
    gate(w_err < 2.5e-7, f"dac_import: imported weights off the source's by {w_err:.3e}")
    say("dac_import", entries=len(sd), file_bytes=os.path.getsize(path), load_s=load_s,
        weight_max_rel_err=w_err, **res, wall_s=time.perf_counter() - t_phase)


TRACE_DIR = os.path.join(REPO, "build", "chip_smoke_trace")


def host_ms(fn, reps: int = 20) -> float:
    fn()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def tooling_phase(m: allpred_ar.CodecModules, a, tc, default: dict) -> None:
    """FLOP and byte counts with their roofline, the native range coder and
    a trace; see the module docstring (phase 22)."""
    t_phase = time.perf_counter()
    peaks = roofline.device_peaks()
    cfg = m.cfg
    out: dict = {"peaks": peaks}
    for b in (1, 32):
        sc = StreamingCodec(m, batch=b, frame_sec=1.0)
        rng = np.random.default_rng(b)
        xa, xt = (torch.from_numpy((0.1 * rng.standard_normal((b, 1, 24000))).astype(np.float32)
                                   ).cuda() for _ in range(2))
        _, codes = sc.encode(xa, xt)
        cost = sc.cost_analysis()
        calls = {"encode": lambda: sc.encode(xa, xt),
                 "decode_from_codes": lambda: sc.decode_from_codes(xa, codes)}
        for name, fn in calls.items():
            ms = device_ms(fn, reps=5)
            c = cost[name]
            gate(np.isfinite(c["flops"]) and c["flops"] > 0 and np.isfinite(c["bytes"]),
                 f"tooling: cost_analysis {name} b{b}: {c}")
            out[f"{name}_b{b}"] = {**c, "device_ms": ms,
                                   **roofline.summarize(c["flops"], c["bytes"], ms, peaks=peaks)}
        front = flops.codec_encode_front_flops(cfg, 24000, b)
        out[f"encode_b{b}"]["encoder_front_flops_closed_form"] = front
    codes = default["bf16"]["codes"][0]
    native = bitstream.pack_codes(codes, cfg.rvq.n_embed)
    pure = bitstream.pack_codes(codes, cfg.rvq.n_embed, force_python=True)
    back = bitstream.unpack_codes(native)
    gate(native == pure and np.array_equal(back, codes)
         and np.array_equal(bitstream.unpack_codes(native, force_python=True), codes),
         "tooling: the native coder's bytes differ from the pure coder's")
    out["coder"] = {
        "bytes_equal": native == pure, "bytes": len(native),
        "pack_native_ms": host_ms(lambda: bitstream.pack_codes(codes, cfg.rvq.n_embed)),
        "pack_python_ms": host_ms(lambda: bitstream.pack_codes(codes, cfg.rvq.n_embed,
                                                               force_python=True), reps=5),
        "unpack_native_ms": host_ms(lambda: bitstream.unpack_codes(native)),
        "unpack_python_ms": host_ms(lambda: bitstream.unpack_codes(native, force_python=True),
                                    reps=5)}
    shutil.rmtree(TRACE_DIR, ignore_errors=True)
    timings: dict = {}
    sc = default["bf16"]["codec"]
    with profiling.trace(TRACE_DIR) as prof:
        with profiling.timed("encode", timings, log=lambda s: None):
            with profiling.annotate("chip_smoke_encode"):
                sc.encode(a, tc)
    with open(os.path.join(TRACE_DIR, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    named = any(e.get("name") == "chip_smoke_encode" for e in events)
    gate(kernels > 0 and named, f"tooling: trace has {kernels} kernel events, annotation {named}")
    out["trace"] = {"path": os.path.relpath(TRACE_DIR, REPO), "events": len(events),
                    "kernel_events": kernels, "annotation_found": named,
                    "timed_ms": timings["encode"][0],
                    "cuda_time_us": sum(e.device_time_total for e in prof.key_averages())}
    say("tooling", **out, wall_s=time.perf_counter() - t_phase)


def tree_at(tree, path):
    for k in path:
        tree = tree[k]
    return np.asarray(tree)


def ptxas_summary(log: str) -> dict:
    """Each kernel's registers, stack, spill bytes and static shared memory,
    as ``nvcc -Xptxas -v`` printed them, by demangled-ish name."""
    out = {}
    for m in re.finditer(r"entry function '(\S+)'.*?\n(?:.*Function properties.*\n)?\s*"
                         r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes "
                         r"spill loads\n.*?Used (\d+) registers(.*)", log):
        name, stack, st, ld, regs, rest = m.groups()
        smem = re.search(r"(\d+) bytes smem", rest)
        short = re.sub(r"^_ZN.*?(\d+)(mma_unit_kernel|prologue_kernel|unit_conv_kernel|"
                       r"unit_tm_kernel|\w*rvq\w*)", r"\2", name)
        out[short[:90]] = {"registers": int(regs), "stack": int(stack),
                           "spill_stores": int(st), "spill_loads": int(ld),
                           "static_smem": int(smem.group(1)) if smem else 0}
    return out


def cuobjdump() -> str:
    """The CUDA toolkit's cuobjdump, or the copy in Triton's package."""
    cands = [shutil.which("cuobjdump"),
             os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")]
    spec = importlib.util.find_spec("triton")
    if spec and spec.submodule_search_locations:
        cands += [os.path.join(p, "backends", "nvidia", "bin", "cuobjdump")
                  for p in spec.submodule_search_locations]
    for cand in cands:
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("cuobjdump not found: the sass check needs it")


def sass_functions(sass: str) -> dict:
    """``cuobjdump -sass`` output split by kernel function: name -> its text."""
    parts = re.split(r"\n\s*Function : (\S+)", sass)
    return dict(zip(parts[1::2], parts[2::2]))


def sass_check() -> None:
    """HMMA (tensor-core MMA) instructions in the two stack libraries' SASS;
    in K2's, none, and no FFMA: its scores stay separately rounded fp32. In
    each fp32 stack kernel (``ffma_unit_kernel``): FFMA, and no HMMA."""
    tool, counts, fp32 = cuobjdump(), {}, {}
    for mod in (resunit, resunit_tm, vq):
        name = mod.LIBRARY[0]
        sass = subprocess.run([tool, "-sass", os.path.join(_build.BUILD_DIR, f"lib{name}.so")],
                              capture_output=True, text=True, timeout=300, check=True).stdout
        counts[f"lib{name}.so"] = {op: len(re.findall(rf"\b{op}\b", sass))
                                   for op in ("HMMA", "FFMA", "FMUL", "FADD")}
        for fn, text in sass_functions(sass).items():
            if "ffma_unit_kernel" in fn:
                short = re.sub(r"^.*ffma_unit_kernelI", "", fn).split("EEEv")[0]
                fp32[f"lib{name}.so:{short}"] = {
                    op: len(re.findall(rf"\b{re.escape(op)}\b", text))
                    for op in ("FFMA", "LDS.128", "HMMA")}
    say("sass", tool=tool, instructions=counts, fp32_kernels=fp32)
    stacks = [counts[f"lib{mod.LIBRARY[0]}.so"]["HMMA"] for mod in (resunit, resunit_tm)]
    gate(all(n > 0 for n in stacks), f"no HMMA instruction in a stack library: {counts}")
    k2 = counts[f"lib{vq.LIBRARY[0]}.so"]
    gate(k2["HMMA"] == 0 and k2["FFMA"] == 0, f"librvq.so scores off plain fp32: {k2}")
    gate(len(fp32) > 0 and all(c["HMMA"] == 0 and c["FFMA"] > 0 for c in fp32.values()),
         f"fp32 stack kernels off FFMA: {fp32}")


ENCODER_STACKS = [(c, t) for c, t, _ in STACKS[:4]]     # the encoder's four stacks


def grouped_cudnn(sets: list, x: torch.Tensor, dilations=resunit.DILATIONS) -> list:
    """-> a call of cuDNN's convolutions of G stacks on x [B, G C, T], each
    as one ``groups=G`` convolution over the weights concatenated along C_out
    (the grouped stacks' library yardstick, convolutions alone)."""
    ws = [(torch.cat([s[i].conv1.weight for s in sets]).to(x.dtype),
           torch.cat([s[i].conv2.weight for s in sets]).to(x.dtype))
          for i in range(len(sets[0]))]

    def run():
        y = x
        for (w7, w1), d in zip(ws, dilations):
            h = torch.nn.functional.conv1d(y, w7, None, dilation=d, padding=3 * d,
                                           groups=len(sets))
            y = torch.nn.functional.conv1d(h, w1, groups=len(sets))
        return y
    return run


@torch.no_grad()
def check_grouped(gen: torch.Generator) -> dict:
    """Grouped K1 at the encoder's four stack shapes and grouped K3 at its two
    narrow ones, two weight sets, batch 1, fp32 and bf16: bit-equal to two
    single-stack launches (gated), within the kernel tolerance of the plain
    version (gated), and timed by CUDA events beside the two single launches
    and cuDNN's grouped convolutions of the same stacks, with the bound of
    both stacks. -> the sums a kernel and dtype over its shapes."""
    sums: dict = {}
    for name, shapes in (("resunit_stack", ENCODER_STACKS),
                         ("resunit_stack_tm", [s for s in ENCODER_STACKS if s[0] < dac.NARROW])):
        tm = name == "resunit_stack_tm"
        kernel = resunit_tm.resunit_stack_tm if tm else resunit.resunit_stack
        plain = resunit_tm.resunit_stack_tm_ref if tm else resunit.resunit_stack_ref
        for c, t in shapes:
            sets = [make_units(c, gen, "cuda") for _ in range(2)]
            post = torch.empty(2 * c).uniform_(0.5, 1.5, generator=gen).cuda()
            for dt in (torch.float32, torch.bfloat16):
                x = torch.randn(1, 2 * c, t, generator=gen).cuda().to(dt)
                rows = x.view(2, c, t)
                xin = rows.transpose(1, 2).contiguous() if tm else rows
                one = [xin[g:g + 1].contiguous() for g in range(2)]
                got = kernel(sets, xin, resunit.DILATIONS, post)
                single = torch.cat([kernel(sets[g], one[g], resunit.DILATIONS,
                                           post[g * c:(g + 1) * c]) for g in range(2)])
                ref = plain(sets, xin, resunit.DILATIONS, post)
                err = rel_err(got, ref)
                same = torch.equal(got, single)
                gate(same, f"grouped {name} C{c}@{t} {dtype_name(dt)}: not bit-equal to two "
                     f"single-stack launches")
                gate(err <= TOL[dt], f"grouped {name} C{c}@{t} {dtype_name(dt)}: rel err "
                     f"{err:.3e} against the plain version")
                b = stack_bound(c, t, dt)
                row = {"ms": cuda_ms(lambda: kernel(sets, xin, resunit.DILATIONS, post)),
                       "two_single_ms": cuda_ms(lambda: [
                           kernel(sets[g], one[g], resunit.DILATIONS, post[g * c:(g + 1) * c])
                           for g in range(2)]),
                       "library_ms": cuda_ms(grouped_cudnn(sets, x)),
                       "bound_ms": 2 * b["bound_ms"]}
                say("grouped_kernel", kernel=name, C=c, T=t, dtype=dtype_name(dt), groups=2,
                    bit_equal_two_single=same, rel_err_plain=err,
                    max_abs_err=float((got.float() - ref.float()).abs().max()), **row)
                tot = sums.setdefault(f"{name}_{dtype_name(dt)}", {})
                for k, v in row.items():
                    tot[k] = tot.get(k, 0.0) + v
    return sums


def dual_encoder_phase(m: allpred_ar.CodecModules, a, tc, many: tuple, default: dict,
                       gen: torch.Generator) -> None:
    """``CodecConfig.vmap_dual_encoder``; see the module docstring (phase 23)."""
    t_phase = time.perf_counter()
    with fp32_exact():
        grouped = check_grouped(gen)
    md = allpred_ar.codec_of(m.audio_dac, m.tactile_dac, m.head,
                             dataclasses.replace(m.cfg, vmap_dual_encoder=True))
    out: dict = {"grouped_kernels": grouped}
    for fast in (False, True):
        dt = dtype_name(dtype_of(fast))
        for batch in (1, 32):
            codecs = {k: StreamingCodec(mod, batch=batch, frame_sec=1.0, fast=fast,
                                        compute_dtype=dtype_of(fast))
                      for k, mod in (("off", m), ("on", md))}
            xa, xt = (a, tc) if batch == 1 else (many[0][:batch], many[1][:batch])
            res = {k: counted(lambda: sc.encode(xa, xt)) for k, sc in codecs.items()}
            want = {"off": expect(fast, k1=8), "on": expect(fast, k1=4)}
            gate(all(res[k][1] == want[k] for k in res),
                 f"dual_encoder {dt} batch {batch}: launches an encode "
                 f"{ {k: r[1] for k, r in res.items()} }, want {want}")
            codes_eq = torch.equal(res["on"][0][1], res["off"][0][1])
            z_eq = torch.equal(res["on"][0][0], res["off"][0][0])
            gate(codes_eq and z_eq, f"dual_encoder {dt} batch {batch}: codes equal {codes_eq}, "
                 f"z_run equal {z_eq} to the sequential encoders'")
            prof = profile_calls(f"dual_encoder_{dt}_b{batch}", {
                k: (lambda sc=sc: sc.encode(xa, xt)) for k, sc in codecs.items()})
            out[f"{dt}_b{batch}"] = {
                "launches": {k: r[1]["resunit_stack"] for k, r in res.items()},
                "codes_equal": codes_eq, "z_run_bit_equal": z_eq,
                **{f"encode_ms_{k}": cuda_ms(lambda: sc.encode(xa, xt), reps=5)
                   for k, sc in codecs.items()},
                **{f"encode_device_ms_{k}": p["device_ms"] for k, p in prof.items()}}
    f32 = latents(md, False, {}, many)
    same = bool((f32["codes"] == default["fp32_many"]["codes"]).all())
    gate(same, "dual_encoder: fp32 codes of the 64 streams differ from the sequential path's")
    out["fp32_many_codes_equal"] = same
    parity("dual_encoder", f32, latents(md, True, {}, many))
    say("dual_encoder", **out, wall_s=time.perf_counter() - t_phase)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()
    faulthandler.dump_traceback_later(900, exit=True)
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke runs on the card only",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True).stdout.strip()
    print(smi, flush=True)
    say("guard", torch=torch.__version__, cuda=torch.version.cuda,
        device=torch.cuda.get_device_name(0))

    t0 = time.perf_counter()
    libraries = [mod.LIBRARY for mod, _, _ in KERNELS.values()]
    _build.build_all(libraries)
    lib = resunit._lib()
    say("build", seconds=time.perf_counter() - t0,
        libraries={name: _build.build_log.get(name, {}).get("seconds", "cached")
                   for name, _ in libraries},
        ptxas={name: ptxas_summary(log["ptxas"]) for name, log in _build.build_log.items()},
        tensor_core_dynamic_smem_bytes={
            f"{tm}x{tn}": {"k7_d9": lib.resunit_smem_bytes(7, tm, tn, 9),
                           "k1": lib.resunit_smem_bytes(1, tm, tn, 1)}
            for tm, tn in resunit.TILES},
        ffma_dynamic_smem_bytes={
            f"{tm}x{tn}": {"k7": lib.resunit_ffma_smem_bytes(7, tm, tn),
                           "k1": lib.resunit_ffma_smem_bytes(1, tm, tn)}
            for tm, tn in resunit.FFMA_TILES})
    sass_check()

    gen = torch.Generator().manual_seed(args.seed)
    with fp32_exact():      # the plain versions' and cuDNN's fp32 convolutions
        records = {"resunit_stack": check_stacks("resunit_stack", STACKS, False, gen),
                   "resunit_stack_tm": check_stacks("resunit_stack_tm", TM_STACKS, True, gen)}
        check_fp32_batch(gen)
        check_rvq_cases(gen)

    t0 = time.perf_counter()
    cfg = CodecConfig().with_rvq(8, 128)
    # copies of the tree made for a card run leave the r5 checkpoints out
    if all(map(os.path.exists, R5)):
        m, weights = load_codec(*R5, cfg), "artifacts/r5 (trained)"
    else:
        m = allpred_ar.codec_init(cfg, torch.Generator().manual_seed(args.seed))
        weights = f"random, seed {args.seed}"
    m = m.cuda()
    torch.cuda.synchronize()
    say("load", seconds=time.perf_counter() - t0, weights=weights,
        params=sum(p.numel() for p in m.parameters()))

    a, tc = signal(args.seed, 24000)
    many = signals(args.seed, PARITY_STREAMS, 24000)
    default = round_trip(m, a, tc, many)
    # K2's line is taken on its path: the AR roll's head RVQ chunks
    k2_launches, records["rvq_lookup"] = head_rvq_path(m, a, tc)
    tm = time_major_round_trip(m, a, tc, many, default)
    tail_kernel_round_trip(m, a, tc, many, default)
    for name, res in (("default", default), ("time_major", tm)):
        profile_phase(name, res["bf16"]["codec"], a, tc, res["bf16"]["codes"])
    say("codec_throughput", layout="default", dtype="bfloat16",
        **default["bf16"]["codec"].throughput_frames_per_sec(repeats=10))
    small_reference(args.seed)
    conceal_phase(m, args.seed, weights)
    plc_eval_phase()
    codec_eval_phase(m, weights)
    parallel_roll_phase(m, a, tc, many, default)
    ctx = train_phase(args.seed, a, tc)
    cached_train_phase(ctx, args.seed)
    plc_train_phase(ctx, args.seed)
    pretrain_phase(args.seed)
    demo_phase()
    evidence_phase()
    mesh_phase(m, a, tc, ctx, args.seed)
    dac_import_phase(args.seed, a)
    tooling_phase(m, a, tc, default)
    dual_encoder_phase(m, a, tc, many, default, gen)
    if FAILED:
        print(f"chip_smoke: {len(FAILED)} gate(s) failed", file=sys.stderr)
        return 1

    # launches: K1 on the default bf16 round trip, K3 on the time-major one,
    # K2 on the head RVQ path
    launches = {"resunit_stack": default["bf16"]["launches"]["resunit_stack"],
                "resunit_stack_tm": tm["bf16"]["launches"]["resunit_stack_tm"],
                "rvq_lookup": k2_launches}
    print(json.dumps({"kernels": [
        rec.line(name, torch.float32 if name == "rvq_lookup" else torch.bfloat16,
                 launches[name]) for name, rec in records.items()]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
