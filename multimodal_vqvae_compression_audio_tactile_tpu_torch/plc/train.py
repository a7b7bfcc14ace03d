"""PLC training: for now only the reading of a run's training condition.

``plc_config_from_meta`` is the JAX package's ``plc/train.py`` function of
that name: the evaluators reproduce the training condition (packet shape,
loss probabilities, ``mask_embed``, predictor depth) from the run's
``meta.json``. The trainer itself is not ported yet.
"""

from __future__ import annotations

import dataclasses
import json
import os

from ..core.config import PLCConfig


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
