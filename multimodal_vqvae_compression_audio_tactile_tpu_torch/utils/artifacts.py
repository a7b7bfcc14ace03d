"""Run-artifact readers and writers: JSON, CSV and a run's ``meta.json``.

The part of the JAX package's ``utils/artifacts.py`` that the evaluators use,
copied: the same files in the same formats, so a run written by either
package reads in the other.
"""

from __future__ import annotations

import csv
import json
import os
from typing import Any, Iterable, Optional


def write_json(path: str, obj: Any) -> None:
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(obj, f, indent=2)


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
