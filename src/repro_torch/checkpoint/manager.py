"""Checkpoint manager — the fault-tolerance substrate.

The port of ``repro.checkpoint.manager``, with the same files on disk, so
a checkpoint either package wrote restores in the other:

* **Atomic**: each checkpoint writes to ``step_XXXXXXXX.tmp/`` and renames
  to ``step_XXXXXXXX/`` only after every leaf and the manifest are fsynced;
  a crash mid-write never corrupts the latest-complete pointer.
* **Self-describing**: ``manifest.json`` records the step, each leaf's
  path (the reference's ``jax.tree`` key paths: dict keys sorted,
  sequence indices, NamedTuple field names, joined by ``/``), file,
  shape and dtype, and the mesh the state was saved under.  bf16 leaves
  are stored as their raw ``uint16`` bits with a ``|bf16`` marker on the
  path.
* **Restore onto any device**: leaves are saved as full host arrays;
  ``restore(like, device=...)`` places them on ``device`` (where the
  reference takes per-leaf shardings: one device here).
* **Async**: ``save_async`` copies the state to host memory synchronously
  (one device->host copy per leaf, so later in-place updates do not
  reach the snapshot) and writes in a background thread; ``wait``
  re-raises a writer's error.
* **Retention**: keeps the newest ``keep`` checkpoints, deleting older
  ones only after a newer one is complete.

A state is nested dicts, tuples, lists and NamedTuples (``None`` holds no
leaf) over tensors, numpy arrays or scalars; restored leaves are tensors.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
from typing import Any, List, Optional

import numpy as np
import torch


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _flatten(tree, path=()):
    """[(path, leaf)] in ``jax.tree``'s order."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _flatten(tree[k], path + (str(k),))]
    if _is_namedtuple(tree):
        return [item for f in tree._fields
                for item in _flatten(getattr(tree, f), path + (f,))]
    if isinstance(tree, (tuple, list)):
        return [item for i, x in enumerate(tree)
                for item in _flatten(x, path + (str(i),))]
    return [(path, tree)]


def _unflatten(like, leaves):
    """``like``'s structure with its leaves taken in order from the
    iterator ``leaves``."""
    if like is None:
        return None
    if isinstance(like, dict):
        out = {k: _unflatten(like[k], leaves) for k in sorted(like)}
        return {k: out[k] for k in like}
    if _is_namedtuple(like):
        return type(like)(*(_unflatten(getattr(like, f), leaves)
                            for f in like._fields))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(x, leaves) for x in like)
    return next(leaves)


def _host(leaf):
    """(tag, numpy copy) of a leaf: bf16 as its raw uint16 bits."""
    if torch.is_tensor(leaf):
        t = leaf.detach().to("cpu", copy=True)
        if t.dtype == torch.bfloat16:
            return "bf16", t.view(torch.int16).numpy().view(np.uint16)
        return "", t.numpy()
    return "", np.array(leaf)


class CheckpointManager:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    # ------------------------------------------------------------------

    def _step_dir(self, step: int) -> str:
        return os.path.join(self.dir, f"step_{step:08d}")

    def steps(self) -> List[int]:
        out = []
        for name in os.listdir(self.dir):
            if name.startswith("step_") and not name.endswith(".tmp"):
                try:
                    out.append(int(name[5:]))
                except ValueError:
                    pass
        return sorted(out)

    def latest_step(self) -> Optional[int]:
        s = self.steps()
        return s[-1] if s else None

    # ------------------------------------------------------------------

    def _write(self, step: int, host_leaves, paths, mesh_desc: str):
        tmp = self._step_dir(step) + ".tmp"
        final = self._step_dir(step)
        if os.path.exists(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        manifest = {"step": step, "mesh": mesh_desc, "leaves": []}
        for i, (arr, path) in enumerate(zip(host_leaves, paths)):
            fname = f"leaf_{i:05d}.npy"
            with open(os.path.join(tmp, fname), "wb") as f:
                np.save(f, arr)
                f.flush()
                os.fsync(f.fileno())
            manifest["leaves"].append({
                "path": path, "file": fname,
                "shape": list(arr.shape), "dtype": str(arr.dtype),
            })
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            f.flush()
            os.fsync(f.fileno())
        if os.path.exists(final):
            shutil.rmtree(final)
        os.rename(tmp, final)  # atomic publish
        self._retain()

    def _retain(self):
        steps = self.steps()
        for s in steps[: -self.keep]:
            shutil.rmtree(self._step_dir(s), ignore_errors=True)

    def _snapshot(self, state):
        arrays, paths = [], []
        for path, leaf in _flatten(state):
            tag, a = _host(leaf)
            arrays.append(a)
            paths.append("/".join(path) + ("|bf16" if tag else ""))
        return arrays, paths

    def save(self, step: int, state, mesh_desc: str = "") -> None:
        self._write(step, *self._snapshot(state), mesh_desc)

    def save_async(self, step: int, state, mesh_desc: str = "") -> None:
        """Snapshot synchronously, write in the background."""
        self.wait()  # one outstanding write at a time
        arrays, paths = self._snapshot(state)

        def work():
            try:
                self._write(step, arrays, paths, mesh_desc)
            except BaseException as e:  # noqa: BLE001 — re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            e, self._error = self._error, None
            raise e

    # ------------------------------------------------------------------

    def restore(self, like, step: Optional[int] = None, device: Any = None):
        """Restore into the structure of ``like`` (the latest step unless
        ``step`` is given).  Each leaf becomes a tensor of its saved dtype
        on ``device``, or else on the device of ``like``'s tensor leaf
        (the CPU for other leaves): the saved device is irrelevant."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = self._step_dir(step)
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
        leaves_like = [leaf for _, leaf in _flatten(like)]
        saved = manifest["leaves"]
        if len(saved) != len(leaves_like):
            raise ValueError(
                f"checkpoint has {len(saved)} leaves, target structure "
                f"has {len(leaves_like)}")
        out = []
        for meta, ref in zip(saved, leaves_like):
            a = np.load(os.path.join(d, meta["file"]))
            if tuple(a.shape) != tuple(np.shape(ref)):
                raise ValueError(
                    f"shape mismatch for {meta['path']}: "
                    f"{a.shape} vs {tuple(np.shape(ref))}")
            t = torch.from_numpy(a)
            if meta["path"].endswith("|bf16"):
                t = torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
            dev = device if device is not None else (
                ref.device if torch.is_tensor(ref) else "cpu")
            out.append(t.to(dev))
        return _unflatten(like, iter(out))
