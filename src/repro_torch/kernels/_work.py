"""The kernels' share of a step-cost count (``launch.roofline.StepCostCounter``).

A cost counter that sees only PyTorch's own ops would miss every Quartet
GEMM: a kernel launched through ``ctypes`` never reaches PyTorch's
dispatcher.  So each kernel wrapper (the function that runs the plain
version on a CPU tensor and launches the kernel on a CUDA tensor, and
counts ``.launches``) is decorated with :func:`counted`: while a counter is
open, the wrapper adds its own kernel's work — B3's 2·M·N·K operations and
its bytes, B5's and B6's operations as ``chip_smoke.py``'s times phase
counts them, and every kernel's bytes read and written, each input read
once and each output written once — and suspends the counting of PyTorch
ops inside itself, so that the plain version's own ops (on the CPU) are not
counted a second time.  With no counter open a wrapper costs one list test.
"""

from __future__ import annotations

import functools

ACTIVE: list = []  # the open counters, innermost last (launch.roofline pushes them)


def counted(cost):
    """Decorate a kernel wrapper: ``cost(*args, **kwargs) -> (operations,
    bytes)`` of the call is added to the innermost open counter, whose op
    counting is suspended for the call's duration."""
    def deco(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            if not ACTIVE or ACTIVE[-1].suspended:
                return fn(*args, **kwargs)
            counter = ACTIVE[-1]
            ops, nbytes = cost(*args, **kwargs)
            counter.add(ops, nbytes)
            counter.suspended += 1
            try:
                return fn(*args, **kwargs)
            finally:
                counter.suspended -= 1
        return run
    return deco


def nbytes(t) -> int:
    return t.numel() * t.element_size()
