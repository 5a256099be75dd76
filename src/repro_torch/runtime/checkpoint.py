"""Atomic checkpoints of nested dicts and lists of tensors and numpy arrays
(PyTorch port of ``repro.runtime.checkpoint``; the file format is the
reference's, so either package reads the other's files).

* A tree flattens to path-keyed numpy arrays inside a single ``.npz``: dict
  keys (in sorted order) and list indices joined with ``/``, the keys
  ``jax.tree_util``'s paths give the reference; ``None`` is an empty
  subtree. Writes go to a temp file + ``os.replace`` (atomic on POSIX), so
  a crash mid-save never corrupts the latest checkpoint. A checkpoint
  counts as complete only once its ``.meta`` JSON sidecar landed too:
  ``CheckpointManager.steps`` skips torn, meta-less writes.
* bf16 has no numpy dtype. A bf16 tensor is stored as the reference's
  bf16 numpy leaves are (``np.savez`` of an ``ml_dtypes.bfloat16`` array):
  its raw 2-byte patterns as ``|V2`` records, read back as bf16.
* ``restore`` returns the template's structure with host leaves (a tensor
  where the template holds a tensor, a numpy array elsewhere), or, given
  ``shardings`` (a matching tree of callables), whatever each callable
  makes of its host leaf: the elastic restore of ``runtime/elastic.py``.
* ``CheckpointManager`` keeps the newest ``keep`` complete steps;
  ``async_save`` copies to the host at once and writes (and collects)
  on a background thread, re-raising a failed write from the next
  ``wait()``.
"""

from __future__ import annotations

import json
import os
import re
import threading

import numpy as np
import torch

BF16_RECORD = np.dtype("V2")   # how numpy stores an ml_dtypes.bfloat16 array


def _host(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.contiguous().view(torch.int16).numpy().view(BF16_RECORD)
        return t.numpy()
    return np.asarray(leaf)


def _paths(tree, prefix=()):
    """(path, leaf) pairs in the reference's flatten order."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from _paths(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _paths(v, prefix + (i,))
    else:
        yield prefix, tree


def _key(path) -> str:
    return "/".join(str(p) for p in path)


def _flatten(tree) -> dict[str, np.ndarray]:
    return {_key(path): _host(leaf) for path, leaf in _paths(tree)}


def _as_template(arr: np.ndarray, like):
    """A stored array as the template leaf's kind: a tensor for a tensor
    (bf16 from its 2-byte records), numpy otherwise."""
    if isinstance(like, torch.Tensor):
        if arr.dtype == BF16_RECORD:
            return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
        return torch.from_numpy(np.array(arr))
    if arr.dtype == BF16_RECORD:
        raise TypeError("a bf16 leaf restores into a tensor template leaf only")
    return arr


def _rebuild(template, leaves):
    if template is None:
        return None
    if isinstance(template, dict):
        return {k: _rebuild(template[k], leaves) for k in sorted(template)}
    if isinstance(template, (list, tuple)):
        return type(template)(_rebuild(v, leaves) for v in template)
    return next(leaves)


def save(path: str, tree, step: int | None = None, extra: dict | None = None):
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    flat = _flatten(tree)
    tmp = path + ".tmp"
    np.savez(tmp, **flat)
    os.replace(tmp + ".npz" if not tmp.endswith(".npz") else tmp, path)
    meta = {"step": step, **(extra or {})}
    mtmp = path + ".meta.tmp"
    with open(mtmp, "w") as f:
        json.dump(meta, f)
    os.replace(mtmp, path + ".meta")


def restore(path: str, template, shardings=None):
    """Rebuild ``template``'s tree from ``path``. ``shardings``: an optional
    matching tree of callables, each taking its host leaf to what the
    caller wants (e.g. this rank's tensor on its device)."""
    with np.load(path) as data:
        flat = dict(data)
    leaves = [_as_template(flat[_key(p)], like) for p, like in _paths(template)]
    if shardings is not None:
        leaves = [fn(x) for x, (_, fn) in zip(leaves, _paths(shardings), strict=True)]
    return _rebuild(template, iter(leaves))


def load_meta(path: str) -> dict:
    with open(path + ".meta") as f:
        return json.load(f)


class CheckpointManager:
    """Step-stamped checkpoints in a directory, newest-``keep`` retention."""

    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None
        self._exc: BaseException | None = None

    def _path(self, step: int) -> str:
        return os.path.join(self.dir, f"ckpt_{step:08d}.npz")

    def steps(self, complete_only: bool = True) -> list[int]:
        out = []
        for f in os.listdir(self.dir):
            m = re.fullmatch(r"ckpt_(\d+)\.npz", f)
            if not m:
                continue
            s = int(m.group(1))
            # A crash between the npz and the meta replace leaves a torn
            # checkpoint; a complete one has both halves.
            if complete_only and not os.path.exists(self._path(s) + ".meta"):
                continue
            out.append(s)
        return sorted(out)

    def latest(self) -> int | None:
        s = self.steps()
        return s[-1] if s else None

    def save(self, step: int, tree, extra: dict | None = None):
        save(self._path(step), tree, step, extra)
        self._gc()

    def async_save(self, step: int, tree, extra: dict | None = None):
        """Copy to the host now; write and collect in the background. A
        failed write re-raises from the next ``wait()`` or
        ``async_save()``."""
        host = {k: v.copy() for k, v in _flatten(tree).items()}
        self.wait()

        def _job():
            try:
                save(self._path(step), host, step, extra)
                self._gc()
            except BaseException as e:  # re-raised from wait()
                self._exc = e

        self._thread = threading.Thread(target=_job)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._exc is not None:
            exc, self._exc = self._exc, None
            raise exc

    def restore(self, template, step: int | None = None, shardings=None):
        step = step if step is not None else self.latest()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        tree = restore(self._path(step), template, shardings)
        return tree, load_meta(self._path(step))

    def _gc(self):
        complete = self.steps()
        for s in complete[: -self.keep]:
            for suffix in ("", ".meta"):
                try:
                    os.remove(self._path(s) + suffix)
                except FileNotFoundError:
                    pass
        if not complete:
            return
        # Torn writes older than the newest complete step are crash debris;
        # a newer meta-less npz may be a write in progress and is spared.
        for s in self.steps(complete_only=False):
            if s < complete[-1] and not os.path.exists(self._path(s) + ".meta"):
                try:
                    os.remove(self._path(s))
                except FileNotFoundError:
                    pass
