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
* Data-parallel state (``shardings=(mesh, specs)``, the state's
  PartitionSpec tree as ``distributed.sharding.partition_state`` gives it)
  is written whole, as the reference writes it: every rank gathers each
  sharded leaf in turn (a collective) and data rank 0 writes.  ``restore``
  with ``shardings`` reads the whole leaves and keeps this rank's slices,
  so a checkpoint written at one data-parallel width restores at any other
  (the reference's elastic ``restore(shardings=)``); the 8-bit AdamW's
  moments too, split or whole as ``partition_state(..., sharded=True)``
  gives them.  A blocking save and
  every restore end or start at a barrier of the data ranks, so no rank
  reads a step that rank 0 is still writing.
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


def _with_specs(tree, specs) -> list:
    """(leaf, its PartitionSpec) pairs in :func:`_leaves` order."""
    if isinstance(tree, dict):
        return [pair for k in sorted(tree) for pair in _with_specs(tree[k], specs[k])]
    if isinstance(tree, (tuple, list)):
        return [pair for c, s in zip(tree, specs) for pair in _with_specs(c, s)]
    if tree is None:
        return []
    return [(tree, specs)]


def _barrier(mesh) -> None:
    from repro_torch.distributed.context import data_group
    from repro_torch.distributed.sharding import data_rank_and_size

    if data_rank_and_size(mesh)[1] > 1:
        torch.distributed.barrier(group=data_group(mesh))


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
             blocking: bool = False, shardings=None) -> None:
        """Copy ``state`` to the host now; write it on a background thread
        (or here, with ``blocking``).  With ``shardings=(mesh, specs)``
        every data rank must call it: the leaves are gathered whole one at
        a time, and data rank 0 alone writes."""
        self.wait()  # one outstanding write at a time
        if shardings is None:
            host = [_to_host(leaf) for leaf in _leaves(state)]
        else:
            from repro_torch.distributed.sharding import data_rank_and_size, unshard_leaf

            mesh, specs = shardings
            writer = data_rank_and_size(mesh)[0] == 0
            host = []
            for leaf, spec in _with_specs(state, specs):
                whole = unshard_leaf(leaf, spec, mesh) if isinstance(leaf, torch.Tensor) else leaf
                if writer:
                    host.append(_to_host(whole))
                del whole
            if not writer:
                if blocking:
                    _barrier(mesh)
                return
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
            if shardings is not None:
                _barrier(shardings[0])
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

    def restore(self, state_like, step: int | None = None, device=None, shardings=None):
        """Restore into the structure of ``state_like`` → ``(state, meta)``.
        Tensors land on ``device`` (by default each like-leaf's own) in the
        dtype they were saved in; int leaves come back as Python ints.
        With ``shardings=(mesh, specs)`` ``state_like`` holds this rank's
        shards and each whole leaf read is cut to its slice.  Raises
        ``ValueError`` when the leaf count or a shape differs."""
        if shardings is not None:
            self.wait()
            _barrier(shardings[0])
        step = step if step is not None else self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.dir}")
        d = os.path.join(self.dir, f"step_{step:09d}")
        with open(os.path.join(d, "meta.json")) as f:
            meta = json.load(f)
        if shardings is None:
            pairs = [(leaf, None) for leaf in _leaves(state_like)]
        else:
            from repro_torch.distributed.sharding import shard_leaf

            mesh, specs = shardings
            pairs = _with_specs(state_like, specs)
        like = [leaf for leaf, _ in pairs]
        if meta["num_leaves"] != len(like):
            raise ValueError(f"checkpoint has {meta['num_leaves']} leaves, "
                             f"state needs {len(like)}")

        def cut(t, spec):
            return t if spec is None else shard_leaf(t, spec, mesh)

        for i, ((leaf, spec), shape) in enumerate(zip(pairs, meta["shapes"])):
            want = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else ()
            got = tuple(shape)
            if isinstance(leaf, torch.Tensor) and spec is not None:
                got = tuple(cut(torch.empty(shape, device="meta"), spec).shape)
            if got != want:
                raise ValueError(f"leaf {i}: checkpoint shape {tuple(shape)} (this rank's "
                                 f"{got}) != expected {want}")
        out = []
        for i, (leaf, spec) in enumerate(pairs):
            arr = np.load(os.path.join(d, f"{i}.npy"))
            dtype = meta["dtypes"][i]
            if not isinstance(leaf, torch.Tensor):
                out.append(int(arr))
                continue
            if dtype == "bfloat16":
                t = torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
            else:
                t = torch.from_numpy(arr.view(np.dtype(dtype)).copy())
            out.append(cut(t, spec).contiguous().to(leaf.device if device is None else device))
        return _unflatten(state_like, iter(out)), meta
