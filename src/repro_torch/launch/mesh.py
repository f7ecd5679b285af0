"""Meshes over the processes of a ``torch.distributed`` world.

Port of ``repro.launch.mesh``.  The port runs one process per device
(SPMD): a process is one rank, and a mesh is a grid of ranks with one
process group per axis line.  :func:`init_distributed` joins the world —
NCCL on the card, gloo on the CPU — from ``RANK`` / ``WORLD_SIZE`` /
``LOCAL_RANK`` (as ``torchrun`` sets them) or from explicit arguments (as
``torch.multiprocessing.spawn`` callers pass them), and picks
``cuda:{local_rank}`` unless the caller asks for the CPU.  Without a world
the process is a world of one.

``torch.distributed.new_group`` must be entered by every rank of the world
in the same order, members or not, so :func:`make_local_mesh` and
:func:`make_serve_meshes` create every line's group on every rank and keep
the ones this rank belongs to.  :func:`make_production_mesh` lays the
reference's 16 × 16 ``(data, model)`` and 2 × 16 × 16 ``(pod, data,
model)`` layouts over the first 256 or 512 ranks; a multi-pod mesh also
holds the ``("pod", "data")`` plane's group, the data-parallel group of
training.  Training takes :func:`make_local_mesh` (``model`` 1: every rank
on ``data``), as the reference's launcher does.
"""

from __future__ import annotations

import datetime
import os

import numpy as np
import torch
import torch.distributed as dist

DEFAULT_TIMEOUT_S = 600


def world_size() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def world_rank() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def rank_device() -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK}`` in an NCCL world, the CPU in
    a gloo world; without a world the card when there is one."""
    if dist.is_initialized():
        if dist.get_backend() != "nccl":
            return torch.device("cpu")
        return torch.device(f"cuda:{int(os.environ.get('LOCAL_RANK', dist.get_rank()))}")
    return torch.device("cuda" if torch.cuda.is_available() else "cpu")


def init_distributed(*, device: str | None = None, rank: int | None = None,
                     world_size: int | None = None, init_method: str | None = None,
                     store=None, timeout_s: float = DEFAULT_TIMEOUT_S) -> torch.device:
    """Join the world as one rank; returns this rank's device.  ``rank`` and
    ``world_size`` default to ``RANK`` / ``WORLD_SIZE``, the rendezvous to
    ``env://`` (``MASTER_ADDR`` / ``MASTER_PORT``) unless ``init_method``
    or ``store`` is given.  ``device="cpu"`` joins over gloo; otherwise the
    rank takes ``cuda:{LOCAL_RANK}`` (``LOCAL_RANK`` defaults to the rank)
    over NCCL.  Every collective of the world and its groups fails after
    ``timeout_s`` seconds instead of hanging."""
    if rank is None or world_size is None:
        if "RANK" not in os.environ or "WORLD_SIZE" not in os.environ:
            raise ValueError("RANK / WORLD_SIZE are not set: start the processes under "
                             "torchrun, or pass rank= and world_size=")
        rank = int(os.environ["RANK"]) if rank is None else rank
        world_size = int(os.environ["WORLD_SIZE"]) if world_size is None else world_size
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    os.environ.setdefault("LOCAL_RANK", str(local_rank))
    if device == "cpu":
        dev, backend = torch.device("cpu"), "gloo"
    else:
        if not torch.cuda.is_available():
            raise RuntimeError("no CUDA device for this rank; pass device='cpu' to run on "
                               "the CPU over gloo")
        dev, backend = torch.device(f"cuda:{local_rank}"), "nccl"
        torch.cuda.set_device(dev)
    if store is None and init_method is None:
        init_method = "env://"
    dist.init_process_group(backend, init_method=init_method, store=store, rank=rank,
                            world_size=world_size,
                            timeout=datetime.timedelta(seconds=timeout_s))
    return dev


class Mesh:
    """A grid of ranks (``ranks`` [*shape]) with named axes.  ``shape`` maps
    axis name → size and ``axis_names`` orders them, as the sharding rules
    read a mesh; ``group(axis)`` is this rank's process group along an axis
    (None on an axis of one rank or outside the world) and
    ``axis_index(axis)`` its position there."""

    def __init__(self, ranks, axis_names, groups: dict | None = None):
        self.ranks = np.asarray(ranks, dtype=np.int64)
        self.axis_names = tuple(axis_names)
        if self.ranks.ndim != len(self.axis_names):
            raise ValueError(f"ranks of shape {self.ranks.shape} for axes {self.axis_names}")
        self.shape = dict(zip(self.axis_names, self.ranks.shape))
        self.size = int(self.ranks.size)
        self._groups = dict(groups or {})
        self.device = rank_device()

    @property
    def first_rank(self) -> int:
        return int(self.ranks.flat[0])

    def contains_this_rank(self) -> bool:
        return bool((self.ranks == world_rank()).any())

    def group(self, axis: str):
        return self._groups.get(axis)

    def axis_index(self, axis: str) -> int:
        where = np.argwhere(self.ranks == world_rank())
        if not len(where):
            raise ValueError(f"rank {world_rank()} is not in this mesh {self.ranks.tolist()}")
        return int(where[0][self.axis_names.index(axis)])

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, ranks={self.ranks.tolist()})"


def _line_groups(ranks: np.ndarray, axis: int):
    """Create the group of every line of ``ranks`` along ``axis`` (on every
    rank, in one order); returns this rank's (None for lines of one)."""
    lines = np.moveaxis(ranks, axis, -1).reshape(-1, ranks.shape[axis])
    if lines.shape[1] == 1 or not dist.is_initialized():
        return None
    mine = None
    for line in lines:
        g = dist.new_group(ranks=[int(r) for r in line])
        if world_rank() in line:
            mine = g
    return mine


def make_local_mesh(model: int = 1) -> Mesh:
    """A ``(data, model)`` mesh over the world's ranks.  ``model`` must
    divide the world size; ``data`` is the cofactor."""
    n = world_size()
    if model < 1:
        raise ValueError(f"model axis must be >= 1, got {model}")
    if model > n or n % model != 0:
        raise ValueError(
            f"model={model} does not divide the world size {n} "
            f"(valid: {[d for d in range(1, n + 1) if n % d == 0]}); start more ranks "
            f"(torchrun --nproc-per-node N)")
    ranks = np.arange(n).reshape(n // model, model)
    groups = {"data": _line_groups(ranks, 0), "model": _line_groups(ranks, 1)}
    return Mesh(ranks, ("data", "model"), groups)


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The reference's production layouts over ranks 0 .. 255 (16 × 16,
    axes ``(data, model)``) or 0 .. 511 (2 × 16 × 16, ``(pod, data,
    model)``).  Raises when the world holds fewer ranks than the mesh."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = int(np.prod(shape))
    if world_size() < need:
        raise ValueError(f"the production mesh {dict(zip(axes, shape))} needs {need} ranks, "
                         f"the world has {world_size()}: start {need} (torchrun "
                         f"--nnodes ... --nproc-per-node ...), or train on make_local_mesh()")
    ranks = np.arange(need).reshape(shape)
    groups = {a: _line_groups(ranks, i) for i, a in enumerate(axes)}
    if multi_pod:  # the (pod, data) planes, one a model index
        groups[("pod", "data")] = _line_groups(ranks.transpose(2, 0, 1).reshape(16, -1).T, 0)
    return Mesh(ranks, axes, groups)


def make_serve_meshes(tp: int = 1, dp: int = 1) -> list[Mesh]:
    """``dp`` one-axis ``('model',)`` meshes of ``tp`` ranks each, over
    disjoint contiguous rank groups: one mesh a data-parallel engine replica.
    Replicas never communicate on the data plane, so they get separate
    groups rather than one ``(data, model)`` mesh."""
    if tp < 1 or dp < 1:
        raise ValueError(f"tp and dp must be >= 1, got tp={tp} dp={dp}")
    n, need = world_size(), tp * dp
    if need > n:
        raise ValueError(f"tp={tp} x dp={dp} needs {need} devices (one rank each), have "
                         f"{n}; start more ranks (torchrun --nproc-per-node N)")
    meshes = []
    for r in range(dp):
        ranks = np.arange(r * tp, (r + 1) * tp)
        group = None
        if tp > 1:
            group = dist.new_group(ranks=[int(x) for x in ranks])
        meshes.append(Mesh(ranks, ("model",), {"model": group}))
    return meshes
