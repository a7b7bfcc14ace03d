"""Carry the JAX package's parameter trees into the port's modules.

Layouts that differ between the two packages:

- conv ``w`` is ``[C_out, C_in, K]`` in both (``nn.Conv1d.weight``);
- the decoder's transposed-conv ``w`` is stored ``[C_out, C_in, k]``, while
  ``nn.ConvTranspose1d.weight`` is ``[C_in, C_out, k]``;
- linear ``w`` is ``[d_in, d_out]``, i.e. ``nn.Linear.weight`` transposed;
- LayerNorm ``scale``/``bias`` are ``nn.LayerNorm``'s ``weight``/``bias``;
- the quantizers' stacked tensors (``vq_books [n, K, D]`` and the backbone's
  projections and codebooks) keep their layout.

Every conversion into the port is strict: a missing, extra or mis-shaped
leaf raises; only a training resume (``load_tolerant``) keeps a leaf the
checkpoint lacks, as the JAX package's resume does. ``head_tree``,
``dac_tree``, ``decoder_tree``, ``plc_head_tree`` and ``disc_tree`` go the
other way, a module to its JAX-layout tree, for the checkpoint writer. The
discriminators' 2D conv weights are OIHW in both packages.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .core.config import CodecConfig, DacConfig, GanConfig
from .losses.gan import Conv2d, Discriminators
from .models.allpred_ar import CodecModules, Head, codec_of
from .models.dac import DAC, Decoder
from .nn.layers import CrossPredictor
from .ops.resunit import ResUnit
from .plc.model import PLCHead, PLCModules
from .train.checkpoint import Path, check_tree, load_checkpoint, load_checkpoint_tolerant

# How a JAX leaf maps to its tensor: None = same layout, "t01" = swap the
# first two axes (transposed conv), "t" = matrix transpose (linear).
Leaf = Tuple[Path, torch.Tensor, Optional[str]]


def _conv(p: Path, m: nn.Module, kind: Optional[str] = None) -> Iterator[Leaf]:
    yield p + ("w",), m.weight, kind
    yield p + ("b",), m.bias, None


def _unit(p: Path, u: ResUnit) -> Iterator[Leaf]:
    yield p + ("snake1", "alpha"), u.snake1.alpha, None
    yield from _conv(p + ("conv1",), u.conv1)
    yield p + ("snake2", "alpha"), u.snake2.alpha, None
    yield from _conv(p + ("conv2",), u.conv2)


def decoder_leaves(dec: Decoder, prefix: Path = ()) -> Iterator[Leaf]:
    """(JAX path, tensor, layout) for every parameter of a backbone's
    decoder, the paths under ``prefix`` (``("decoder",)`` in a backbone
    tree; none in a decoder checkpoint such as ``dec_plc.msgpack``)."""
    yield from _conv(prefix + ("in_conv",), dec.in_conv)
    for i, b in enumerate(dec.blocks):
        p = prefix + ("blocks", i)
        yield p + ("snake", "alpha"), b.snake.alpha, None
        yield from _conv(p + ("up",), b.up, "t01")
        for j, u in enumerate(b.units):
            yield from _unit(p + ("units", j), u)
    yield prefix + ("out_snake", "alpha"), dec.out_snake.alpha, None
    yield from _conv(prefix + ("out_conv",), dec.out_conv)


def dac_leaves(m: DAC) -> Iterator[Leaf]:
    """(JAX path, tensor, layout) for every parameter of a backbone."""
    enc, q = m.encoder, m.quantizer
    yield from _conv(("encoder", "in_conv"), enc.in_conv)
    for i, b in enumerate(enc.blocks):
        p = ("encoder", "blocks", i)
        for j, u in enumerate(b.units):
            yield from _unit(p + ("units", j), u)
        yield p + ("snake", "alpha"), b.snake.alpha, None
        yield from _conv(p + ("down",), b.down)
    yield ("encoder", "out_snake", "alpha"), enc.out_snake.alpha, None
    yield from _conv(("encoder", "out_conv"), enc.out_conv)
    yield from decoder_leaves(m.decoder, ("decoder",))
    for name in ("codebooks", "in_bias", "in_proj", "out_bias", "out_proj"):
        yield ("quantizer", name), getattr(q, name), None


def _predictor(p: Path, pr: CrossPredictor) -> Iterator[Leaf]:
    for name in ("ln_q", "ln_kv", "ffn_ln"):
        ln = getattr(pr, name)
        yield p + (name, "scale"), ln.weight, None
        yield p + (name, "bias"), ln.bias, None
    for name in ("q_proj", "k_proj", "v_proj", "out", "ffn_in", "ffn_out"):
        lin = getattr(pr, name)
        yield p + (name, "w"), lin.weight, "t"
        if lin.bias is not None:
            yield p + (name, "b"), lin.bias, None


def head_leaves(h: Head) -> Iterator[Leaf]:
    """(JAX path, tensor, layout) for every parameter of the codec head."""
    yield from _predictor(("predict",), h.predict)
    yield ("tokennorm", "scale"), h.tokennorm.weight, None
    yield ("tokennorm", "bias"), h.tokennorm.bias, None
    yield ("scale",), h.scale, None
    for name in ("proj_down", "proj_up"):
        lin = getattr(h, name)
        yield (name, "w"), lin.weight, "t"
        yield (name, "b"), lin.bias, None
    yield ("vq_books",), h.vq_books, None
    yield ("vq_counts",), h.vq_counts, None


def plc_head_leaves(h: PLCHead) -> Iterator[Leaf]:
    """(JAX path, tensor, layout) for every parameter of a PLC head:
    ``predict/...``, ``tokennorm/...``, ``mask_embed`` and, for a stacked
    head, ``predict_extra/<i>/...``."""
    yield from _predictor(("predict",), h.predict)
    yield ("tokennorm", "scale"), h.tokennorm.weight, None
    yield ("tokennorm", "bias"), h.tokennorm.bias, None
    yield ("mask_embed",), h.mask_embed, None
    for i, blk in enumerate(h.predict_extra):
        yield from _predictor(("predict_extra", i), blk)


def disc_leaves(d: Discriminators) -> Iterator[Leaf]:
    """(JAX path, tensor, layout) for every parameter of the discriminators:
    ``mpd/<i>/layers/<j>``, ``mpd/<i>/post`` and ``mstftd/<i>/{pre, mid/<j>,
    tail, post}``, each a ``w`` and a ``b``."""
    def conv(p: Path, c: Conv2d) -> Iterator[Leaf]:
        yield p + ("w",), c.w, None
        yield p + ("b",), c.b, None

    for i, m in enumerate(d.mpd):
        for j, layer in enumerate(m.layers):
            yield from conv(("mpd", i, "layers", j), layer)
        yield from conv(("mpd", i, "post"), m.post)
    for i, m in enumerate(d.mstftd):
        yield from conv(("mstftd", i, "pre"), m.pre)
        for j, layer in enumerate(m.mid):
            yield from conv(("mstftd", i, "mid", j), layer)
        yield from conv(("mstftd", i, "tail"), m.tail)
        yield from conv(("mstftd", i, "post"), m.post)


def _jax_shape(t: torch.Tensor, kind: Optional[str]) -> Tuple[int, ...]:
    s = tuple(t.shape)
    if kind == "t01":
        return (s[1], s[0]) + s[2:]
    if kind == "t":
        return s[::-1]
    return s


def _to_torch(a: np.ndarray, kind: Optional[str]) -> torch.Tensor:
    if kind == "t01":
        a = np.swapaxes(a, 0, 1)
    elif kind == "t":
        a = a.T
    return torch.tensor(np.asarray(a, dtype=np.float32))     # a copy


def _to_jax_layout(t: torch.Tensor, kind: Optional[str]) -> torch.Tensor:
    """A view of t in the JAX layout (no copy)."""
    t = t.detach()
    if kind == "t01":
        return t.transpose(0, 1)
    if kind == "t":
        return t.T
    return t


def _tree(leaves: Iterator[Leaf]) -> dict:
    """Nested dicts of JAX-layout tensor views, integer path parts as lists
    and keys in sorted order, as the JAX package's checkpoints hold them."""
    root: dict = {}
    for p, t, kind in leaves:
        node = root
        for k in p[:-1]:
            node = node.setdefault(k, {})
        node[p[-1]] = _to_jax_layout(t, kind)

    def order(node):
        if not isinstance(node, dict):
            return node
        if all(isinstance(k, int) for k in node):
            return [order(node[i]) for i in range(len(node))]
        return {k: order(node[k]) for k in sorted(node)}
    return order(root)


def head_tree(h: Head) -> dict:
    """The codec head as the JAX package's ``head`` tree, of tensor views in
    JAX layout (``proj_*``/``predict`` linears' ``w`` = ``weight.T``)."""
    return _tree(head_leaves(h))


def dac_tree(m: DAC) -> dict:
    """A backbone as the JAX package's parameter tree, of tensor views."""
    return _tree(dac_leaves(m))


def decoder_tree(dec: Decoder) -> dict:
    """A backbone's decoder as the JAX package's ``decoder`` tree, of tensor
    views (what ``dec_plc.msgpack`` holds)."""
    return _tree(decoder_leaves(dec))


def plc_head_tree(h: PLCHead) -> dict:
    """A PLC head as the JAX package's head tree, of tensor views."""
    return _tree(plc_head_leaves(h))


def disc_tree(d: Discriminators) -> dict:
    """The discriminators as the JAX package's ``d_params`` tree, of tensor
    views."""
    return _tree(disc_leaves(d))


def _template(leaves: Iterator[Leaf]) -> Dict[Path, Tuple[int, ...]]:
    return {p: _jax_shape(t, kind) for p, t, kind in leaves}


def dac_template(cfg: DacConfig) -> Dict[Path, Tuple[int, ...]]:
    """{JAX path: JAX shape} of a backbone tree, for the strict loader."""
    with torch.device("meta"):
        return _template(dac_leaves(DAC(cfg)))


def head_template(cfg: CodecConfig) -> Dict[Path, Tuple[int, ...]]:
    """{JAX path: JAX shape} of a codec-head tree, for the strict loader."""
    with torch.device("meta"):
        return _template(head_leaves(Head(cfg)))


def plc_head_template(cfg: CodecConfig, n_layers: int = 1) -> Dict[Path, Tuple[int, ...]]:
    """{JAX path: JAX shape} of a PLC-head tree of ``n_layers`` blocks."""
    with torch.device("meta"):
        return _template(plc_head_leaves(PLCHead(cfg, n_layers)))


def disc_template(gcfg: GanConfig) -> Dict[Path, Tuple[int, ...]]:
    """{JAX path: JAX shape} of a discriminator tree, for the strict loader."""
    with torch.device("meta"):
        return _template(disc_leaves(Discriminators(gcfg)))


@torch.no_grad()
def _load(leaves: Iterator[Leaf], tree: Any) -> None:
    leaves = list(leaves)
    arrays = check_tree(tree, _template(iter(leaves)))
    for p, t, kind in leaves:
        t.copy_(_to_torch(arrays[p], kind))


@torch.no_grad()
def load_tolerant(leaves: Iterator[Leaf], path: str) -> Tuple[int, dict]:
    """Resume: load a checkpoint into ``leaves`` one by one, keeping a
    leaf's own value where the file lacks it or holds it at another shape (a
    checkpoint from before a schema addition, such as ``vq_counts``).
    -> (epoch, hist)."""
    leaves = list(leaves)
    found, epoch, hist = load_checkpoint_tolerant(path, _template(iter(leaves)))
    for p, t, kind in leaves:
        if p in found:
            t.copy_(_to_torch(found[p], kind))
    return epoch, hist


def load_head_tolerant(h: Head, path: str) -> Tuple[int, dict]:
    """``load_tolerant`` of a codec-head checkpoint into ``h``."""
    return load_tolerant(head_leaves(h), path)


def _part(tree: Any, name: str) -> Any:
    return getattr(tree, name) if hasattr(tree, "_fields") else tree[name]


def params_from_jax(tree: Any, cfg: CodecConfig) -> CodecModules:
    """JAX ``CodecParams`` (or a mapping with ``audio_dac``, ``tactile_dac``
    and ``head``) of numpy-convertible leaves -> ``CodecModules`` on the CPU."""
    m = CodecModules(cfg)
    _load(dac_leaves(m.audio_dac), _part(tree, "audio_dac"))
    _load(dac_leaves(m.tactile_dac), _part(tree, "tactile_dac"))
    _load(head_leaves(m.head), _part(tree, "head"))
    return m


def dac_from_jax(tree: Any, cfg: DacConfig) -> DAC:
    """A backbone from the JAX package's parameter tree (numpy-convertible
    leaves), checked strictly against ``cfg``, on the CPU."""
    m = DAC(cfg)
    _load(dac_leaves(m), tree)
    return m


def load_dac(path: str, cfg: DacConfig) -> DAC:
    """A backbone from its checkpoint, checked strictly against ``cfg``, on
    the CPU."""
    tree, _, _ = load_checkpoint(path, dac_template(cfg))
    return dac_from_jax(tree, cfg)


def load_dac_checkpoint(m: DAC, path: str) -> Tuple[int, dict]:
    """Load a backbone checkpoint into ``m`` where it lives, strictly;
    -> (epoch, hist)."""
    tree, epoch, hist = load_checkpoint(path, dac_template(m.encoder.cfg))
    _load(dac_leaves(m), tree)
    return epoch, hist


def disc_from_jax(tree: Any, gcfg: GanConfig) -> Discriminators:
    """Discriminators from the JAX package's ``d_params`` tree, checked
    strictly against ``gcfg``, on the CPU."""
    d = Discriminators(gcfg)
    _load(disc_leaves(d), tree)
    return d


def load_disc(path: str, gcfg: GanConfig) -> Discriminators:
    """The discriminators of a ``disc_last.msgpack``, checked strictly
    against ``gcfg``, on the CPU."""
    tree, _, _ = load_checkpoint(path, disc_template(gcfg))
    return disc_from_jax(tree, gcfg)


def codec_from_backbones(audio_dac: DAC, tactile_dac: DAC, head_path: str,
                         cfg: CodecConfig) -> CodecModules:
    """Codec on already-loaded backbone modules (used as they are, not
    copied) and a head checkpoint, checked strictly against ``cfg``; the head
    goes where the audio backbone lives. An evaluation of many sweep runs
    reads the backbone once this way."""
    tree, _, _ = load_checkpoint(head_path, head_template(cfg))
    m = codec_of(audio_dac, tactile_dac, Head(cfg), cfg)
    _load(head_leaves(m.head), tree)
    m.head.to(next(audio_dac.parameters()).device)
    return m


def decoder_template(cfg: DacConfig) -> Dict[Path, Tuple[int, ...]]:
    """{JAX path: JAX shape} of a decoder tree (``dec_plc.msgpack``)."""
    with torch.device("meta"):
        return _template(decoder_leaves(Decoder(cfg)))


def load_decoder(path: str, cfg: DacConfig) -> Decoder:
    """A tactile decoder from a decoder checkpoint (the inpainting decoder's
    ``dec_plc.msgpack``, from either package), checked strictly, on the
    CPU."""
    tree, _, _ = load_checkpoint(path, decoder_template(cfg))
    dec = Decoder(cfg)
    _load(decoder_leaves(dec), tree)
    return dec


def load_codec(backbone_path: str, head_path: str, cfg: CodecConfig) -> CodecModules:
    """Codec from a backbone checkpoint (one module serving as both the audio
    and the tactile backbone, as the JAX evaluation scripts load it) and a
    head checkpoint. Both are checked strictly against ``cfg``."""
    bb = load_dac(backbone_path, cfg.dac)
    return codec_from_backbones(bb, bb, head_path, cfg)


def plc_params_from_jax(tree: Any, cfg: CodecConfig, n_layers: int = 1) -> PLCModules:
    """JAX ``CodecParams`` of a PLC model (``head`` a PLC head of
    ``n_layers`` blocks) -> ``PLCModules`` on the CPU."""
    m = PLCModules(cfg, n_layers)
    _load(dac_leaves(m.audio_dac), _part(tree, "audio_dac"))
    _load(dac_leaves(m.tactile_dac), _part(tree, "tactile_dac"))
    _load(plc_head_leaves(m.head), _part(tree, "head"))
    return m


def load_plc_head(path: str, cfg: CodecConfig, n_layers: int = 1) -> PLCHead:
    """A PLC head of ``n_layers`` blocks from its checkpoint, checked
    strictly, on the CPU."""
    tree, _, _ = load_checkpoint(path, plc_head_template(cfg, n_layers))
    h = PLCHead(cfg, n_layers)
    _load(plc_head_leaves(h), tree)
    return h


def load_plc(backbone_path: str, head_path: str, cfg: CodecConfig,
             n_layers: int = 1) -> PLCModules:
    """Concealment model from a backbone checkpoint (serving as both the audio
    and the tactile backbone, as the JAX evaluation scripts load it) and a PLC
    head: ``head_path`` is a checkpoint, or a run directory whose
    ``best.msgpack`` is read, ``last.msgpack`` where there is no best (a run
    cut short may never write one). Both are checked strictly."""
    if os.path.isdir(head_path):
        best = os.path.join(head_path, "best.msgpack")
        head_path = best if os.path.exists(best) else os.path.join(head_path, "last.msgpack")
    bb, _, _ = load_checkpoint(backbone_path, dac_template(cfg.dac))
    head, _, _ = load_checkpoint(head_path, plc_head_template(cfg, n_layers))
    return plc_params_from_jax({"audio_dac": bb, "tactile_dac": bb, "head": head}, cfg,
                               n_layers)
