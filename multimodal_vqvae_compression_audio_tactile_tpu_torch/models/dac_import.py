"""Weight import: a ``descript-audio-codec`` PyTorch state dict -> the port's DAC.

The port of the JAX package's ``models/dac_import.py``. The reference's
system sits on two frozen pretrained DAC-24kHz models, and code-index parity
with it needs their exact codebooks, so this module maps descript's state
dict onto a backbone of ``DacConfig``: the weight-normalised convolutions
fused (``weight = g * v / ||v||`` per output channel, or the plain
``weight``), the transposed up-convolutions' ``[C_in, C_out, k]`` layout,
and the factorized quantizer's 1x1 projections (with their biases) and
codebooks. The leaves are computed by the JAX package's numpy code, to the
bit, into its tree layout, and loaded strictly into a ``DAC`` through
``convert.py`` (``dac_from_jax``). No weights are fetched: a checkpoint is a
local file.

Descript's layout (weight-normalised convs):
  encoder.block.{i}...  Snake1d alpha [1, C, 1]; Conv1d weight_v/weight_g or fused
  quantizer.quantizers.{i}.in_proj/out_proj (1x1 convs), .codebook.weight [K, cd]
  decoder.model.{i}...
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from ..convert import dac_from_jax
from ..core.config import DacConfig
from .dac import DAC


def _fuse_weight_norm(sd: Dict[str, np.ndarray], prefix: str) -> np.ndarray:
    """weight = g * v / ||v|| (per output channel), or the plain weight."""
    if prefix + ".weight" in sd:
        return np.asarray(sd[prefix + ".weight"])
    v = np.asarray(sd[prefix + ".weight_v"])
    g = np.asarray(sd[prefix + ".weight_g"])
    norm = np.sqrt((v ** 2).sum(axis=(1, 2), keepdims=True)) + 1e-12
    return g * v / norm


def _conv(sd, prefix) -> dict:
    return {
        "w": _fuse_weight_norm(sd, prefix).astype(np.float32),
        "b": np.asarray(sd[prefix + ".bias"]).astype(np.float32),
    }


def _snake(sd, prefix) -> dict:
    return {"alpha": np.asarray(sd[prefix + ".alpha"]).reshape(-1)
            .astype(np.float32)}


def _resunit(sd, prefix) -> dict:
    # descript's ResidualUnit: block.0 Snake, block.1 Conv(7, dil), block.2 Snake,
    # block.3 Conv(1)
    return {
        "snake1": _snake(sd, f"{prefix}.block.0"),
        "conv1": _conv(sd, f"{prefix}.block.1"),
        "snake2": _snake(sd, f"{prefix}.block.2"),
        "conv2": _conv(sd, f"{prefix}.block.3"),
    }


def import_encoder(sd: Dict[str, np.ndarray], cfg: DacConfig) -> dict:
    # descript's Encoder: block.0 Conv(7); block.{1..R} EncoderBlock
    # (block.{0,1,2} ResidualUnits, block.3 Snake, block.4 strided Conv);
    # block.R+1 Snake; block.R+2 Conv(3)
    R = len(cfg.encoder_rates)
    out = {"in_conv": _conv(sd, "encoder.block.0"), "blocks": []}
    for i in range(1, R + 1):
        p = f"encoder.block.{i}.block"
        out["blocks"].append({
            "units": [_resunit(sd, f"{p}.{j}") for j in range(3)],
            "snake": _snake(sd, f"{p}.3"),
            "down": _conv(sd, f"{p}.4"),
        })
    out["out_snake"] = _snake(sd, f"encoder.block.{R + 1}")
    out["out_conv"] = _conv(sd, f"encoder.block.{R + 2}")
    return out


def import_decoder(sd: Dict[str, np.ndarray], cfg: DacConfig) -> dict:
    # descript's Decoder: model.0 Conv(7); model.{1..R} DecoderBlock (block.0
    # Snake, block.1 ConvTranspose, block.{2,3,4} ResidualUnits); model.R+1
    # Snake; model.R+2 Conv(7) [+ tanh]
    R = len(cfg.decoder_rates)
    out = {"in_conv": _conv(sd, "decoder.model.0"), "blocks": []}
    for i in range(1, R + 1):
        p = f"decoder.model.{i}.block"
        up = _conv(sd, f"{p}.1")
        # descript's ConvTranspose1d weight: [C_in, C_out, k]; the tree
        # stores (c_out, c_in, k), which convert.py swaps back
        up["w"] = np.transpose(up["w"], (1, 0, 2))
        out["blocks"].append({
            "snake": _snake(sd, f"{p}.0"),
            "up": up,
            "units": [_resunit(sd, f"{p}.{j}") for j in (2, 3, 4)],
        })
    out["out_snake"] = _snake(sd, f"decoder.model.{R + 1}")
    out["out_conv"] = _conv(sd, f"decoder.model.{R + 2}")
    return out


def import_quantizer(sd: Dict[str, np.ndarray], cfg: DacConfig) -> dict:
    n = cfg.n_codebooks
    in_proj, in_bias, out_proj, out_bias, codebooks = [], [], [], [], []
    for i in range(n):
        p = f"quantizer.quantizers.{i}"
        w_in = _fuse_weight_norm(sd, f"{p}.in_proj")    # [cd, C, 1]
        w_out = _fuse_weight_norm(sd, f"{p}.out_proj")  # [C, cd, 1]
        in_proj.append(w_in[:, :, 0].T)                  # [C, cd]
        out_proj.append(w_out[:, :, 0].T)                # [cd, C]
        # descript's projection convs carry biases; dropping them breaks
        # code-index parity (caught by the torch-twin end-to-end test)
        in_bias.append(np.asarray(sd[f"{p}.in_proj.bias"]))
        out_bias.append(np.asarray(sd[f"{p}.out_proj.bias"]))
        codebooks.append(np.asarray(sd[f"{p}.codebook.weight"]))
    return {
        "in_proj": np.stack(in_proj).astype(np.float32),
        "in_bias": np.stack(in_bias).astype(np.float32),
        "out_proj": np.stack(out_proj).astype(np.float32),
        "out_bias": np.stack(out_bias).astype(np.float32),
        "codebooks": np.stack(codebooks).astype(np.float32),
    }


def import_tree(sd, cfg: DacConfig) -> dict:
    """The JAX package's parameter tree of ``sd`` (numpy leaves); ``sd`` a
    mapping of numpy arrays or tensors."""
    sd = {k: (v.detach().cpu().numpy() if hasattr(v, "detach") else np.asarray(v))
          for k, v in sd.items()}
    return {
        "encoder": import_encoder(sd, cfg),
        "decoder": import_decoder(sd, cfg),
        "quantizer": import_quantizer(sd, cfg),
    }


def import_torch_dac_state_dict(sd, cfg: DacConfig) -> DAC:
    """A backbone (on the CPU) from a descript-format state dict, checked
    strictly against ``cfg``."""
    return dac_from_jax(import_tree(sd, cfg), cfg)


def load_torch_dac(path: str, cfg: DacConfig) -> DAC:
    """A backbone (on the CPU) from a local descript checkpoint (``.pth``:
    the state dict, or ``{"state_dict": ..., "metadata": ...}``), read with
    ``weights_only=True``."""
    blob = torch.load(path, map_location="cpu", weights_only=True)
    sd = blob.get("state_dict", blob) if isinstance(blob, dict) else blob
    if "metadata" in sd and "state_dict" in sd:
        sd = sd["state_dict"]
    return import_torch_dac_state_dict(sd, cfg)
