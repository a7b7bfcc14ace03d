"""Rate-distortion and example plots.

Port of the JAX package's ``eval/plots.py``. ``rate_distortion_plots`` draws
the same five figures (ST-SIM and PSNR against kbps and against the
compression ratio, and the compression ratio against kbps): errorbar curves
with +-CI fill bands, the proposed runs grouped by embed size K with the
markers {128: o, 256: ^, 512: D}, ST-SIM over [0.80, 1.00].

The JAX package's ``plot_examples`` is split in two here. ``example_signals``
does the model work: the best run's head on the backbones, the proposed
forward on ``device`` (``None``: the card) in fp32, the resampling, the
alignment (``align_and_psnr_raw``) and both log-mel spectrograms; it returns
arrays. ``draw_examples`` draws them: a waveform overlay and side-by-side
log-mel spectrograms per example, as the JAX package does. matplotlib is
imported only by the drawing functions, so the model work runs where there
is none.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence

import numpy as np
import torch

from .. import convert
from ..core.config import CodecConfig
from ..dsp.mel import mel_mag
from ..dsp.resample import resample
from ..models import allpred_ar
from ..utils import artifacts
from ..utils.wav_io import load_wav_mono
from .metrics import align_and_psnr_raw
from .serving import resolve_device

EMBED_MARKERS = {128: "o", 256: "^", 512: "D"}
Y_STSIM = (0.80, 1.00)
MEL_HOP = 128            # mel_mag's hop, for the spectrograms' time axis
RD_FIGURES = ("stsim_vs_kbps.png", "psnr_vs_kbps.png", "stsim_vs_cr.png", "psnr_vs_cr.png",
              "cr_vs_bitrate.png")


def _pyplot():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def _group_by_embed(rows: Sequence[dict]) -> dict:
    groups: dict = {}
    for r in rows:
        groups.setdefault(int(r["embed"]), []).append(r)
    for k in groups:
        groups[k] = sorted(groups[k], key=lambda x: x["kbps"])
    return groups


def _errfill(plt, x, y, ci, label, marker, color=None):
    x, y, ci = np.asarray(x), np.asarray(y), np.asarray(ci)
    line, = plt.plot(x, y, marker + "-", lw=2.0, ms=0, label=label, color=color)
    plt.scatter(x, y, s=36, zorder=3, color=line.get_color())
    plt.fill_between(x, y - ci, y + ci, alpha=0.20, color=line.get_color())


def _one_rd_plot(plt, dac24: dict, proposed: Sequence[dict], vc: Sequence[dict],
                 metric: str, ylabel: str, out_path: str, ylim=None) -> None:
    plt.figure(figsize=(9, 6))
    if dac24:
        qs = sorted(dac24, key=lambda q: dac24[q]["kbps"])
        _errfill(plt, [dac24[q]["kbps"] for q in qs],
                 [dac24[q][f"{metric}_mean"] for q in qs],
                 [dac24[q][f"{metric}_ci95"] for q in qs],
                 "DAC-class backbone", "s")
    for embed, rows in _group_by_embed(proposed).items():
        _errfill(plt, [r["kbps"] for r in rows],
                 [r[f"{metric}_mean"] for r in rows],
                 [r[f"{metric}_ci95"] for r in rows],
                 f"Proposed K={embed}", EMBED_MARKERS.get(embed, "x"))
    if vc:
        rows = sorted(vc, key=lambda r: r["kbps"])
        _errfill(plt, [r["kbps"] for r in rows],
                 [r[f"{metric}_mean"] for r in rows],
                 [r[f"{metric}_ci95"] for r in rows],
                 "VC-PWQ", "v")
    plt.xlabel("Bitrate (kbps)")
    plt.ylabel(ylabel)
    if ylim:
        plt.ylim(*ylim)
    plt.grid(True, alpha=0.4)
    plt.legend()
    plt.tight_layout()
    plt.savefig(out_path, dpi=150)
    plt.close()


def rate_distortion_plots(dac24: dict, proposed: Sequence[dict],
                          vc: Sequence[dict], out_dir: str) -> List[str]:
    """The five rate-distortion figures in ``out_dir``; -> their paths.
    Either baseline may be empty."""
    plt = _pyplot()
    os.makedirs(out_dir, exist_ok=True)
    outs = []
    for metric, ylabel, fname, ylim in [
        ("stsim", "ST-SIM", "stsim_vs_kbps.png", Y_STSIM),
        ("psnr", "PSNR (dB, global peak)", "psnr_vs_kbps.png", None),
    ]:
        p = os.path.join(out_dir, fname)
        _one_rd_plot(plt, dac24, proposed, vc, metric, ylabel, p, ylim)
        outs.append(p)

    # compression-ratio variants, all three systems, as the kbps figures
    def cr_axis(rows):
        return [r["compression_ratio"] for r in rows]

    dac_rows = sorted((dac24 or {}).values(),
                      key=lambda r: r.get("compression_ratio") or 0)
    dac_rows = [r for r in dac_rows if r.get("compression_ratio")]
    vc_rows = sorted([r for r in (vc or []) if r.get("compression_ratio")],
                     key=lambda r: r["compression_ratio"])
    for metric, ylabel, fname in [("stsim", "ST-SIM", "stsim_vs_cr.png"),
                                  ("psnr", "PSNR (dB)", "psnr_vs_cr.png")]:
        plt.figure(figsize=(9, 6))
        if dac_rows:
            _errfill(plt, cr_axis(dac_rows),
                     [r[f"{metric}_mean"] for r in dac_rows],
                     [r[f"{metric}_ci95"] for r in dac_rows],
                     "DAC-class backbone", "s")
        for embed, rows in _group_by_embed(proposed).items():
            rows = sorted(rows, key=lambda r: r["compression_ratio"] or 0)
            _errfill(plt, cr_axis(rows), [r[f"{metric}_mean"] for r in rows],
                     [r[f"{metric}_ci95"] for r in rows],
                     f"Proposed K={embed}", EMBED_MARKERS.get(embed, "x"))
        if vc_rows:
            _errfill(plt, cr_axis(vc_rows),
                     [r[f"{metric}_mean"] for r in vc_rows],
                     [r[f"{metric}_ci95"] for r in vc_rows],
                     "VC-PWQ", "v")
        plt.xlabel("Compression ratio (x)")
        plt.ylabel(ylabel)
        plt.grid(True, alpha=0.4)
        plt.legend()
        plt.tight_layout()
        p = os.path.join(out_dir, fname)
        plt.savefig(p, dpi=150)
        plt.close()
        outs.append(p)

    # compression ratio against bitrate, all three systems: plain lines (the
    # ratio is deterministic given the rate)
    plt.figure(figsize=(9, 6))
    for embed, rows in _group_by_embed(proposed).items():
        rows = [r for r in rows if r.get("compression_ratio")]
        plt.plot([r["kbps"] for r in rows], cr_axis(rows),
                 EMBED_MARKERS.get(embed, "x") + "-", lw=2.0, ms=6,
                 label=f"Proposed K={embed}")
    if dac_rows:
        d = sorted(dac_rows, key=lambda r: r["kbps"])
        plt.plot([r["kbps"] for r in d], cr_axis(d), "s-", lw=2.0, ms=6,
                 label="DAC-class backbone")
    if vc_rows:
        v = sorted(vc_rows, key=lambda r: r["kbps"])
        plt.plot([r["kbps"] for r in v], cr_axis(v), "v-", lw=2.0, ms=6,
                 label="VC-PWQ")
    plt.xlabel("Bitrate (kbps)")
    plt.ylabel("Compression ratio (x)")
    plt.grid(True, alpha=0.4)
    plt.legend()
    plt.tight_layout()
    p = os.path.join(out_dir, "cr_vs_bitrate.png")
    plt.savefig(p, dpi=150)
    plt.close()
    outs.append(p)
    return outs


def _log_mel_db(x: np.ndarray) -> np.ndarray:
    x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return 20 * np.log10(mel_mag(x).numpy()[0] + 1e-8)


def example_signals(best_run: dict, cfg: CodecConfig, backbones: dict, pairs,
                    device=None, num_examples: int = 10, peak: float = 1.0) -> List[dict]:
    """The model work of the example figures: for each of the first
    ``num_examples`` pairs, the best run's (``best_run``: a proposed row with
    ``books``, ``embed`` and ``path``) full encode and decode of the pair,
    with the transmitter's per-file scale, at the model's rate on
    ``device``, resampled to the tactile rate and aligned to the reference.
    backbones: {"audio": DAC, "tactile": DAC}. -> one dict an example:
    ``stem``, ``sr`` (the tactile rate), ``ref`` and ``est`` (aligned, [T]),
    ``mel_ref_db`` and ``mel_est_db`` (20 log10 of the max-normalised mel
    magnitude at the model's rate, [n_mels, frames]), ``mel_frame_s`` (the
    spectrogram's hop in seconds) and ``psnr_db`` (the aligned pair's PSNR
    at ``peak``: the evaluator's number for the file when ``peak`` is its
    global peak)."""
    dev = resolve_device(device)
    books = int(best_run["books"])
    run_cfg = cfg.with_rvq(books, int(best_run["embed"]))
    bbs = {k: v.to(dev).eval() for k, v in backbones.items()}
    m = convert.codec_from_backbones(bbs["audio"], bbs["tactile"],
                                     os.path.join(best_run["path"], "best.msgpack"),
                                     run_cfg).to(dev).eval()
    sr24 = run_cfg.dac.sample_rate

    out = []
    for a_path, t_path, stem in list(pairs)[:num_examples]:
        a_raw, sr_a = load_wav_mono(a_path)
        t_raw, sr_t = load_wav_mono(t_path)
        scale = max(float(np.abs(t_raw).max()), 1e-8)
        a24 = np.asarray(resample(a_raw / scale, sr_a, sr24), np.float32)
        t24 = np.asarray(resample(t_raw / scale, sr_t, sr24), np.float32)
        L = min(a24.shape[-1], t24.shape[-1])
        y24 = allpred_ar.forward_eval(
            m, torch.from_numpy(np.ascontiguousarray(a24[None, :, :L])).to(dev),
            torch.from_numpy(np.ascontiguousarray(t24[None, :, :L])).to(dev),
            n_books_use=books)[0].cpu().numpy()
        est = np.asarray(resample(y24 * scale, sr24, sr_t))
        psnr, r_a, e_a = align_and_psnr_raw(t_raw, est, peak)
        r24 = np.asarray(resample(r_a, sr_t, sr24))
        e24 = np.asarray(resample(e_a, sr_t, sr24))
        out.append({"stem": stem, "sr": int(sr_t), "ref": r_a[0], "est": e_a[0],
                    "mel_ref_db": _log_mel_db(r24), "mel_est_db": _log_mel_db(e24),
                    "mel_frame_s": MEL_HOP / float(sr24), "psnr_db": psnr})
    return out


def draw_examples(examples: Sequence[dict], out_dir: str) -> List[str]:
    """``proposed_example_{NN}.png`` (waveform overlay) and
    ``proposed_example_{NN}_mel.png`` (log-mel, original beside
    reconstructed) of each of ``example_signals``' examples; -> the paths."""
    plt = _pyplot()
    os.makedirs(out_dir, exist_ok=True)
    outs = []
    for idx, ex in enumerate(examples):
        stem, r, e = ex["stem"], ex["ref"], ex["est"]
        t_axis = np.arange(r.shape[-1]) / float(ex["sr"])
        fig, ax = plt.subplots(figsize=(8, 3))
        ax.plot(t_axis, r, label="Original", linewidth=1.0)
        ax.plot(t_axis, e, label="Reconstructed", linewidth=1.0, alpha=0.8)
        ax.set_xlabel("Time (s)")
        ax.set_ylabel("Amplitude")
        ax.set_title(stem)
        ax.grid(True, alpha=0.3)
        ax.legend(loc="upper right", fontsize=8)
        fig.tight_layout()
        p = os.path.join(out_dir, f"proposed_example_{idx+1:02d}.png")
        fig.savefig(p, dpi=180)
        plt.close(fig)
        outs.append(p)

        Mr, Me = ex["mel_ref_db"], ex["mel_est_db"]
        t_mel = np.arange(Mr.shape[-1]) * ex["mel_frame_s"]
        fig, axes = plt.subplots(1, 2, figsize=(10, 3), sharey=True)
        for ax_i, (M, title) in zip(axes, [(Mr, "Original"), (Me, "Reconstructed")]):
            im = ax_i.imshow(M, aspect="auto", origin="lower",
                             extent=[t_mel[0], t_mel[-1], 0, M.shape[0]])
            ax_i.set_title(title)
            ax_i.set_xlabel("Time (s)")
        axes[0].set_ylabel("Mel bin")
        fig.suptitle(f"Log-mel Spectrogram - {stem}", y=0.98)
        fig.tight_layout(rect=[0, 0, 0.93, 0.92])
        cax = fig.add_axes([0.94, 0.15, 0.015, 0.65])
        fig.colorbar(im, cax=cax).set_label("Log-mel (dB)")
        p = os.path.join(out_dir, f"proposed_example_{idx+1:02d}_mel.png")
        fig.savefig(p, dpi=180)
        plt.close(fig)
        outs.append(p)
    return outs


def best_by_stsim(rows: Sequence[dict]) -> Optional[dict]:
    """The proposed row of the highest mean ST-SIM (the run whose examples
    are drawn), the first of equals; None without rows."""
    return max(rows, key=lambda r: r["stsim_mean"]) if rows else None


def draw_benchmark(dac24: dict, proposed: Sequence[dict], vc: Sequence[dict],
                   examples: Sequence[dict], out_dir: str, log=print) -> List[str]:
    """The rate-distortion figures and the examples' figures in ``out_dir``
    where matplotlib is installed (-> their paths); else one line names them
    (-> [])."""
    if not artifacts.have_matplotlib():
        log(artifacts.not_drawn(f"{', '.join(RD_FIGURES)} and proposed_example_NN.png / "
                                f"_mel.png of {len(examples)} examples"))
        return []
    return rate_distortion_plots(dac24, proposed, vc, out_dir) + draw_examples(examples, out_dir)
