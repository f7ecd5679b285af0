"""Roofline terms and a step-cost counter for the H100.

Port of the part of ``repro.launch.roofline`` that has a meaning without
compiled HLO: :func:`model_flops`, :func:`roofline_terms` and
:func:`save_report`, with the H100 SXM's constants in place of the TPU's.

In place of the reference's HLO analyzer, :class:`StepCostCounter` records
the operations and a bytes proxy of one step call while the call runs:

* a ``TorchDispatchMode`` adds 2·M·N·K for every ``aten.mm``/``bmm``/
  ``addmm``/``baddbmm`` (composite ops such as ``matmul``, ``linear`` and
  ``einsum`` are decomposed through their own kernels, so their products
  are counted as the ops that run), and the output bytes of every op that
  is neither a view nor a factory (the factories mirror the reference's
  trivial ops: constants, iota); an in-place op counts the bytes it writes,
  at most the size of the largest other tensor it reads;
* each hand-written kernel's wrapper adds its own kernel's work while the
  counter is open and suspends the op counting inside itself
  (``kernels._work``): a counter that saw only PyTorch's ops would miss
  every Quartet GEMM, and on the CPU would count the plain versions' ops.

The counter never changes what runs: the ops it sees are the ops that run,
with their own kernels and their own results.  It slows the host side of
the call it counts, so a profiler counts one call of each step shape and
memoizes the result (``serve.telemetry.profiling``).
"""

from __future__ import annotations

import json

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.kernels import _work

# H100 SXM data-sheet peaks (dense bf16 tensor-core rate, HBM3 bandwidth,
# NVLink 4 over all 18 links, both directions): not measured numbers
PEAK_FLOPS_BF16 = 989e12  # FLOP/s
HBM_BW = 3.35e12  # B/s
NVLINK_BW = 900e9  # B/s

_MATMULS = ("mm", "bmm", "addmm", "baddbmm")
_FACTORIES = frozenset((
    "empty", "empty_like", "empty_strided", "new_empty", "new_empty_strided", "zeros",
    "zeros_like", "new_zeros", "ones", "ones_like", "new_ones", "full", "full_like",
    "new_full", "arange", "scalar_tensor", "lift_fresh", "lift_fresh_copy"))


def _matmul_flops(name: str, args) -> int:
    a, b = (args[0], args[1]) if name in ("mm", "bmm") else (args[1], args[2])
    *batch, m, k = a.shape
    n = b.shape[-1]
    lead = 1
    for d in batch:
        lead *= d
    return 2 * lead * m * n * k


def _written_bytes(func, args, out) -> int:
    """Output bytes of one op: 0 for a view or a factory; for an in-place op
    its output, at most the largest other tensor argument's element count in
    the output's element size."""
    schema = func._schema
    name = func.overloadpacket.__name__
    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    if name in _FACTORIES or not tensors:
        return 0
    outs = out if isinstance(out, (tuple, list)) else (out,)
    total = 0
    for ret, o in zip(schema.returns, outs):
        if not isinstance(o, torch.Tensor):
            continue
        alias = ret.alias_info
        if alias is not None and not alias.is_write:
            continue  # a view
        size = o.numel() * o.element_size()
        if alias is not None:  # in place: what it writes, at most the input it reads
            others = [t.numel() for t in tensors if t is not o]
            if others:
                size = min(size, max(others) * o.element_size())
        total += size
    return total


class StepCostCounter(TorchDispatchMode):
    """``with StepCostCounter() as c: step(...)`` → ``c.flops``, ``c.hbm_bytes``
    of that call (see the module docstring for what each counts)."""

    def __init__(self):
        super().__init__()
        self.flops = 0.0
        self.hbm_bytes = 0.0
        self.suspended = 0  # > 0 while a kernel wrapper runs

    def add(self, flops: float, nbytes: float) -> None:
        self.flops += flops
        self.hbm_bytes += nbytes

    def __enter__(self):
        _work.ACTIVE.append(self)
        return super().__enter__()

    def __exit__(self, *exc):
        _work.ACTIVE.remove(self)
        return super().__exit__(*exc)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        TorchDispatchMode.__enter__(self)  # the mode is off inside its handler
        try:
            out = func.decompose(*args, **kwargs)  # a composite op: count what it runs
        finally:
            TorchDispatchMode.__exit__(self, None, None, None)
        if out is not NotImplemented:
            return out
        out = func(*args, **kwargs)
        if not self.suspended:
            name = func.overloadpacket.__name__
            if name in _MATMULS:
                self.flops += _matmul_flops(name, args)
            self.hbm_bytes += _written_bytes(func, args, out)
        return out


def roofline_terms(agg: dict) -> dict:
    """The three roofline terms of ``agg`` (``flops``, ``mem_bytes``,
    ``total_collective_bytes``), in seconds on one H100 at its data-sheet
    peaks, and the one that dominates."""
    compute = agg["flops"] / PEAK_FLOPS_BF16
    memory = agg["mem_bytes"] / HBM_BW
    collective = agg.get("total_collective_bytes", 0.0) / NVLINK_BW
    dominant = max((("compute", compute), ("memory", memory), ("collective", collective)),
                   key=lambda kv: kv[1])[0]
    return {"compute_s": compute, "memory_s": memory, "collective_s": collective,
            "dominant": dominant}


def model_flops(cfg, shape, include_backward: bool) -> float:
    """Analytic MODEL_FLOPS: 6·N·D (train) or 2·N·D (forward), N = active
    parameters (a MoE's top-k experts), D = tokens (one a sequence when
    decoding).  ``shape`` has the reference's ``ShapeConfig`` fields
    ``global_batch``, ``seq_len`` and ``kind`` ("train", "prefill" or
    "decode")."""
    n = cfg.n_active_params() if cfg.family == "moe" else cfg.n_params()
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    per_tok = 6 * n if include_backward else 2 * n
    return float(per_tok) * tokens


def save_report(path: str, report: dict):
    with open(path, "w") as f:
        json.dump(report, f, indent=2, default=str)
