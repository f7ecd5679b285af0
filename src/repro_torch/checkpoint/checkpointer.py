"""Atomic, asynchronous checkpointing with restore onto a chosen device.

Port of ``repro.checkpoint.checkpointer``, with its on-disk layout (one
directory per step)::

    <dir>/step_000000123.tmp/        # written first
        meta.json                    # step, num_leaves, shapes, dtypes, extra meta
        <leaf-idx>.npy               # one file per leaf, on the host
    <dir>/step_000000123/            # renamed when complete

* Readers never see a partial checkpoint: the rename is the commit point,
  and a writer that died leaves only a ``.tmp`` that the next save removes.
* ``save`` copies every leaf to the host before it returns; the files are
  written on a background thread.
* The last ``keep`` checkpoints are kept.
* Leaves are taken in the reference's order: a named tuple's fields in
  order, a dict's keys sorted (``repro_torch.tree``), so a checkpoint of a
  ``TrainState`` holds the reference's leaves in the reference's order and
  either package restores the other's.  bfloat16 leaves are stored as their
  uint16 bits under the dtype name ``"bfloat16"``; a Python int leaf (the
  step counters) as an int32 scalar, as the reference's step is.
* The step rides in ``meta.json``; the data pipeline is indexed by step, so
  a resume replays the exact token stream.
"""

from __future__ import annotations

import json
import os
import shutil
import threading
import time

import numpy as np
import torch


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in _leaves(tree[k])]
    if isinstance(tree, (tuple, list)):
        return [leaf for child in tree for leaf in _leaves(child)]
    if tree is None:
        return []
    return [tree]


def _unflatten(like, it):
    if isinstance(like, dict):
        return {k: _unflatten(like[k], it) for k in sorted(like)}
    if isinstance(like, tuple) and hasattr(like, "_fields"):
        return type(like)(*(_unflatten(c, it) for c in like))
    if isinstance(like, (tuple, list)):
        return type(like)(_unflatten(c, it) for c in like)
    if like is None:
        return None
    return next(it)


def _to_host(leaf) -> tuple[np.ndarray, str]:
    """A leaf as a host array and the name of its dtype."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().to("cpu")
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        arr = t.numpy()
        return arr, str(arr.dtype)
    if isinstance(leaf, (int, np.integer)) and not isinstance(leaf, bool):
        return np.asarray(leaf, np.int32), "int32"
    raise TypeError(f"cannot checkpoint a leaf of type {type(leaf).__name__}")


class Checkpointer:
    def __init__(self, directory: str, keep: int = 3):
        self.dir = directory
        self.keep = keep
        os.makedirs(directory, exist_ok=True)
        self._thread: threading.Thread | None = None

    # ----------------------------------------------------------- save
    def save(self, step: int, state, extra_meta: dict | None = None,
             blocking: bool = False) -> None:
        """Copy ``state`` to the host now; write it on a background thread
        (or here, with ``blocking``)."""
        self.wait()  # one outstanding write at a time
        host = [_to_host(leaf) for leaf in _leaves(state)]
        meta = {
            "step": int(step),
            "num_leaves": len(host),
            "shapes": [list(a.shape) for a, _ in host],
            "dtypes": [dt for _, dt in host],
            "time": time.time(),
            **(extra_meta or {}),
        }

        def write():
            tmp = os.path.join(self.dir, f"step_{step:09d}.tmp")
            final = os.path.join(self.dir, f"step_{step:09d}")
            os.makedirs(tmp, exist_ok=True)
            for i, (arr, _) in enumerate(host):
                np.save(os.path.join(tmp, f"{i}.npy"), arr)
            with open(os.path.join(tmp, "meta.json"), "w") as f:
                json.dump(meta, f)
            if os.path.exists(final):
                shutil.rmtree(final)
            os.rename(tmp, final)  # commit point
            self._gc()

        if blocking:
            write()
        else:
            self._thread = threading.Thread(target=write, daemon=True)
            self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _gc(self) -> None:
        steps = self.all_steps()
        for s in steps[: -self.keep] if self.keep > 0 else []:
            shutil.rmtree(os.path.join(self.dir, f"step_{s:09d}"), ignore_errors=True)
        # orphaned .tmp directories of writers that died
        for name in os.listdir(self.dir):
            if name.endswith(".tmp"):
                shutil.rmtree(os.path.join(self.dir, name), ignore_errors=True)

    # -------------------------------------------------------- restore
    def all_steps(self) -> list[int]:
        return sorted(int(name.split("_")[1]) for name in os.listdir(self.dir)
                      if name.startswith("step_") and not name.endswith(".tmp"))

    def latest_step(self) -> int | None:
        steps = self.all_steps()
        return steps[-1] if steps else None

    def restore(self, state_like, step: int | None = None, device=None):
        """Restore into the structure of ``state_like`` → ``(state, meta)``.
        Tensors land on ``device`` (by default each like-leaf's own) in the
        dtype they were saved in; int leaves come back as Python ints.
        Raises ``ValueError`` when the leaf count or a shape differs."""
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        like = _leaves(state_like)
        if meta["num_leaves"] != len(like):
            raise ValueError(f"checkpoint has {meta['num_leaves']} leaves, "
                             f"state needs {len(like)}")
        for i, (leaf, shape) in enumerate(zip(like, meta["shapes"])):
            want = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else ()
            if tuple(shape) != want:
                raise ValueError(f"leaf {i}: checkpoint shape {tuple(shape)} != expected {want}")
        out = []
        for i, leaf in enumerate(like):
            arr = np.load(os.path.join(d, f"{i}.npy"))
            dtype = meta["dtypes"][i]
            if not isinstance(leaf, torch.Tensor):
                out.append(int(arr))
                continue
            if dtype == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr.view(np.dtype(dtype)).copy())
            out.append(t.to(leaf.device if device is None else device))
        return _unflatten(state_like, iter(out)), meta
