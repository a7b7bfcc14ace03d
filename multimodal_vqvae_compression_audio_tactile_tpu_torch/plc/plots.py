"""PLC example plots: waveform overlays with masked spans + mel with mask stripes.

Port of the JAX package's ``plc/plots.py``: for a concealed file, a waveform
figure with the lost spans shaded red and side-by-side mel spectrograms with
the mask's stripes; ``select_top_k`` picks the files the PLC evaluator's
second pass re-runs and draws (the top K by PSNR union the top K by ST-SIM).
matplotlib is imported only by ``plot_plc_example``.
"""

from __future__ import annotations

import os
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch

from ..dsp.mel import mel_mag
from ..eval.metrics import token_mask_to_sample_mask


def _mask_spans(sample_mask: np.ndarray, sr: float):
    d = np.diff(np.concatenate([[0], sample_mask.astype(np.int8), [0]]))
    starts = np.where(d == 1)[0] / sr
    ends = np.where(d == -1)[0] / sr
    return list(zip(starts, ends))


def plot_plc_example(
    out_dir: str,
    stem: str,
    ref: np.ndarray,
    est: np.ndarray,
    latent_mask: np.ndarray,
    sr: int,
    mel_fn: Optional[Callable[[np.ndarray], np.ndarray]] = None,
    mel_hop: int = 128,
) -> List[str]:
    """``plc_{stem}_wave.png`` and ``plc_{stem}_mel.png`` for one file;
    -> their paths. ``mel_fn``: x [T] -> mel magnitude [n_mels, frames]
    (default: ``dsp/mel.py::mel_mag`` at ``sr``)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    os.makedirs(out_dir, exist_ok=True)
    ref = np.asarray(ref).reshape(-1)
    est = np.asarray(est).reshape(-1)
    T = min(ref.size, est.size)
    ref, est = ref[:T], est[:T]
    sm = token_mask_to_sample_mask(np.asarray(latent_mask, bool), T)
    t_axis = np.arange(T) / float(sr)
    spans = _mask_spans(sm, float(sr))

    outs = []
    fig, ax = plt.subplots(figsize=(10, 3.2))
    for s, e in spans:
        ax.axvspan(s, e, color="red", alpha=0.15, lw=0)
    ax.plot(t_axis, ref, label="Original", linewidth=0.8)
    ax.plot(t_axis, est, label="Concealed", linewidth=0.8, alpha=0.8)
    ax.set_xlabel("Time (s)")
    ax.set_ylabel("Amplitude")
    ax.set_title(f"{stem} (red = lost packets)")
    ax.grid(True, alpha=0.3)
    ax.legend(loc="upper right", fontsize=8)
    fig.tight_layout()
    p = os.path.join(out_dir, f"plc_{stem}_wave.png")
    fig.savefig(p, dpi=160)
    plt.close(fig)
    outs.append(p)

    if mel_fn is None:
        def mel_fn(x):
            x = torch.from_numpy(np.ascontiguousarray(x, np.float32)[None])
            return mel_mag(x, sr=sr).numpy()[0]

    Mr = 20 * np.log10(mel_fn(ref) + 1e-8)
    Me = 20 * np.log10(mel_fn(est) + 1e-8)
    n_frames = Mr.shape[-1]
    frame_centers = np.arange(n_frames) * mel_hop
    t_lat = latent_mask.shape[-1]
    token_idx = np.clip((frame_centers / (T / max(1, t_lat))).astype(np.int64),
                        0, t_lat - 1)
    frame_mask = np.asarray(latent_mask, bool)[token_idx]
    t_mel = frame_centers / float(sr)

    fig, axes = plt.subplots(1, 2, figsize=(11, 3.2), sharey=True)
    for ax_i, (M, title) in zip(axes, [(Mr, "Original"), (Me, "Concealed")]):
        im = ax_i.imshow(M, aspect="auto", origin="lower",
                         extent=[t_mel[0], t_mel[-1] if n_frames > 1 else 1,
                                 0, M.shape[0]])
        for s, e in _mask_spans(frame_mask, 1.0):
            ax_i.axvspan(t_mel[min(int(s), n_frames - 1)],
                         t_mel[min(int(e), n_frames - 1)],
                         color="red", alpha=0.18, lw=0)
        ax_i.set_title(title)
        ax_i.set_xlabel("Time (s)")
    axes[0].set_ylabel("Mel bin")
    fig.suptitle(f"Log-mel - {stem}", y=0.98)
    fig.tight_layout(rect=[0, 0, 0.93, 0.92])
    cax = fig.add_axes([0.94, 0.15, 0.015, 0.65])
    fig.colorbar(im, cax=cax).set_label("dB")
    p = os.path.join(out_dir, f"plc_{stem}_mel.png")
    fig.savefig(p, dpi=160)
    plt.close(fig)
    outs.append(p)
    return outs


def select_top_k(rows: Sequence[dict], k: int = 10) -> set:
    """Top-K stems by PSNR union top-K by ST-SIM."""
    by_psnr = sorted(rows, key=lambda r: r["psnr_global_db"], reverse=True)[:k]
    by_stsim = sorted(rows, key=lambda r: r["stsim_global"], reverse=True)[:k]
    return {r["stem"] for r in by_psnr} | {r["stem"] for r in by_stsim}
