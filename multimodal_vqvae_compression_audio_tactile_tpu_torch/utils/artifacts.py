"""Run-artifact readers and writers: JSON, CSV, a run's ``hist.json`` and
``meta.json``, and the sweep's ``rvqB{B}_K{K}`` run directories.

The JAX package's ``utils/artifacts.py``: the same files in the same
formats, so a run written by either package reads in the other, and the
same loss-curve figure (``write_curves``). matplotlib is imported only inside
the functions that draw: a machine without it (the card's) runs everything
else, and ``have_matplotlib`` tells the callers whether a figure can be
drawn there.
"""

from __future__ import annotations

import csv
import glob
import json
import os
import re
from pathlib import Path
from typing import Any, Iterable, Optional, Tuple


def write_json(path: str, obj: Any) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)


def write_hist(out_dir: str, hist: dict) -> None:
    write_json(os.path.join(out_dir, "hist.json"), hist)


def have_matplotlib() -> bool:
    """Whether matplotlib can be imported here (it is imported lazily, by
    the functions that draw)."""
    try:
        import matplotlib  # noqa: F401
    except ImportError:
        return False
    return True


def not_drawn(what: str) -> str:
    """The one line that stands in for figures that are not drawn."""
    return f"{what} not drawn: matplotlib is not installed"


def write_curves(out_dir: str, hist: dict, title: str = "training curves") -> str:
    """The loss curves' PNG, ``out_dir/curves.png`` (the JAX package's
    figure: train and val against the epoch)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    plt.figure(figsize=(11, 5))
    for key in ("train", "val"):
        if key in hist and hist[key]:
            plt.plot(hist[key], label=key)
    plt.xlabel("Epoch")
    plt.ylabel("Loss")
    plt.grid(True)
    plt.legend()
    plt.title(title)
    plt.tight_layout()
    out = os.path.join(out_dir, "curves.png")
    plt.savefig(out)
    plt.close()
    return out


def write_meta(out_dir: str, meta: dict) -> None:
    write_json(os.path.join(out_dir, "meta.json"), meta)


def read_meta(out_dir: str) -> Optional[dict]:
    """meta.json contents, or None if absent/unreadable."""
    p = os.path.join(out_dir, "meta.json")
    if not os.path.isfile(p):
        return None
    try:
        with open(p) as f:
            return json.load(f)
    except (OSError, ValueError):
        return None


def write_csv(path: str, rows: Iterable[dict], fieldnames: list[str]) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=fieldnames)
        w.writeheader()
        for r in rows:
            w.writerow({k: r.get(k, "") for k in fieldnames})


def run_dir_name(books: int, embed: int) -> str:
    """``rvqB{B}_K{K}``, a sweep run's directory name."""
    return f"rvqB{books}_K{embed}"


def parse_run_dir(path: str) -> Optional[Tuple[int, int]]:
    """(books, embed) of a run: from its meta.json (``rvq_books``,
    ``rvq_embed``), else from the directory's name; None when neither says."""
    books = embed = None
    meta_path = os.path.join(path, "meta.json")
    if os.path.isfile(meta_path):
        try:
            with open(meta_path) as f:
                meta = json.load(f)
            books = int(meta.get("rvq_books", 0)) or None
            embed = int(meta.get("rvq_embed", 0)) or None
        except (OSError, ValueError, TypeError, AttributeError):
            pass
    if books is None or embed is None:
        m = re.match(r"rvqB(\d+)_K(\d+)$", Path(path).name)
        if not m:
            return None
        books, embed = int(m.group(1)), int(m.group(2))
    return books, embed


def discover_runs(sweep_root: str) -> list:
    """The ``rvqB*_K*`` run directories under ``sweep_root``, sorted."""
    return sorted(p for p in glob.glob(os.path.join(sweep_root, "rvqB*_K*"))
                  if os.path.isdir(p))
