"""The JAX package's msgpack checkpoints: read strictly, written alike.

A checkpoint is ``{"model": tree, "epoch": int64, "hist_json": str}`` written
by flax; lists inside the tree are stored as ``{"0": ..., "1": ...}`` maps and
come back here as lists. Given a template ``{path: shape}``, the loader raises
on any missing, extra or mis-shaped leaf: a tolerant load that keeps template
leaves on mismatch once silently lost a backbone's blocks. Only a training
resume reads tolerantly (``load_checkpoint_tolerant``), as the JAX package's
does.

``save_checkpoint`` writes the same payload through ``utils/msgpack_write.py``
(to a temporary file, then ``os.replace``), so the JAX package's loader reads
the port's checkpoints; ``AsyncCheckpointer`` writes them from a thread.
"""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch

from ..utils import msgpack_read, msgpack_write

Path = Tuple[Any, ...]


def _lists(tree: Any) -> Any:
    """{"0": a, "1": b} -> [a, b], recursively."""
    if isinstance(tree, dict):
        out = {k: _lists(v) for k, v in tree.items()}
        if out and all(isinstance(k, str) for k in out) \
                and sorted(out) == sorted(str(i) for i in range(len(out))):
            return [out[str(i)] for i in range(len(out))]
        return out
    return tree


def flatten(tree: Any, prefix: Path = ()) -> Iterator[Tuple[Path, Any]]:
    """Leaves of a tree of dicts, lists/tuples and NamedTuples, with paths of
    keys (str) and list indices (int)."""
    if hasattr(tree, "_fields"):
        items = zip(tree._fields, tree)
    elif isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        yield prefix, tree
        return
    for k, v in items:
        yield from flatten(v, prefix + (k,))


def check_tree(tree: Any, template: Dict[Path, Tuple[int, ...]]) -> Dict[Path, np.ndarray]:
    """{path: array} of ``tree``, after checking it against ``template``
    exactly: same leaf paths, same shapes. Raises ValueError otherwise."""
    leaves = {p: np.asarray(v) for p, v in flatten(tree)}
    missing = sorted(map(str, template.keys() - leaves.keys()))
    extra = sorted(map(str, leaves.keys() - template.keys()))
    if missing or extra:
        raise ValueError(f"checkpoint tree does not match: missing {missing[:8]}"
                         f"{'...' if len(missing) > 8 else ''}, extra {extra[:8]}"
                         f"{'...' if len(extra) > 8 else ''}")
    bad = [(p, leaves[p].shape, tuple(s)) for p, s in template.items()
           if leaves[p].shape != tuple(s)]
    if bad:
        raise ValueError(f"checkpoint leaf shapes do not match (path, stored, "
                         f"expected): {bad[:8]}")
    return leaves


def load_checkpoint(path: str, template: Optional[Dict[Path, Tuple[int, ...]]] = None,
                    ) -> Tuple[Any, int, dict]:
    """-> (model tree of numpy arrays, epoch, hist). With ``template`` the
    model tree is checked strictly (``check_tree``)."""
    payload = msgpack_read.read_file(path)
    if not isinstance(payload, dict) or "model" not in payload:
        raise ValueError(f"{path}: not a checkpoint payload")
    tree = _lists(payload["model"])
    if template is not None:
        check_tree(tree, template)
    hist_json = payload.get("hist_json") or ""
    return tree, int(payload.get("epoch", 0)), json.loads(hist_json) if hist_json else {}


def load_checkpoint_tolerant(path: str, template: Dict[Path, Tuple[int, ...]],
                             ) -> Tuple[Dict[Path, np.ndarray], int, dict]:
    """-> ({path: array} of the template's leaves that the file holds at the
    template's shape, epoch, hist). The caller keeps its own value for the
    others (a resume from a checkpoint older than a head-schema addition)."""
    payload = msgpack_read.read_file(path)
    if not isinstance(payload, dict) or "model" not in payload:
        raise ValueError(f"{path}: not a checkpoint payload")
    stored = {p: np.asarray(v) for p, v in flatten(_lists(payload["model"]))}
    found = {p: stored[p] for p, shape in template.items()
             if p in stored and stored[p].shape == tuple(shape)}
    hist_json = payload.get("hist_json") or ""
    return found, int(payload.get("epoch", 0)), json.loads(hist_json) if hist_json else {}


def to_host(tree: Any) -> Any:
    """Tensors -> numpy arrays (on the host), dicts and lists kept."""
    if isinstance(tree, dict):
        return {k: to_host(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [to_host(v) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.detach().cpu().numpy()
    return np.asarray(tree)


def save_checkpoint(path: str, tree: Any, epoch: int, hist: Optional[dict] = None) -> None:
    """Write ``{"model": tree, "epoch": int64, "hist_json": json}`` as the
    JAX package does (tensors move to the host): to ``path + ".tmp"``, then
    renamed over ``path``."""
    payload = {"model": to_host(tree), "epoch": np.int64(epoch),
               "hist_json": json.dumps(hist or {})}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    blob = msgpack_write.packb(payload)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(blob)
    os.replace(tmp, path)


def snapshot(tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: snapshot(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [snapshot(v) for v in tree]
    return tree.detach().clone() if isinstance(tree, torch.Tensor) else tree


class AsyncCheckpointer:
    """Checkpoint writes on one background thread, in order. ``save``
    snapshots the tree where it lives (``clone()``, on the card a device
    copy), so training goes on while the writer moves it to the host and
    writes it; ``wait`` drains the queue and raises a writer's error, which
    the next ``save`` raises too."""

    def __init__(self):
        self._q: "queue.Queue" = queue.Queue()
        self._err: Optional[BaseException] = None
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def _run(self) -> None:
        while True:
            item = self._q.get()
            if item is None:
                return
            path, tree, epoch, hist = item
            try:
                save_checkpoint(path, tree, epoch, hist)
            except BaseException as e:  # raised on the next save()/wait()
                self._err = e
            finally:
                self._q.task_done()

    def _raise(self) -> None:
        if self._err is not None:
            err, self._err = self._err, None
            raise err

    def save(self, path: str, tree: Any, epoch: int, hist: Optional[dict] = None) -> None:
        self._raise()
        # the loop goes on mutating hist: freeze it now
        hist_copy = json.loads(json.dumps(hist)) if hist else None
        self._q.put((path, snapshot(tree), epoch, hist_copy))

    def wait(self) -> None:
        self._q.join()
        self._raise()

    def close(self) -> None:
        self.wait()
        self._q.put(None)
        self._thread.join()
