"""Bench-regression gate: compare a fresh serving-benchmark document against
a baseline with per-metric tolerance bands.

Port of ``repro.serve.telemetry.regression`` (pure Python, copied: the same
rules, deltas, table and exit codes).  A schema-validated benchmark
document that is never *compared* lets a silent perf regression ship
clean.  This module closes that loop:

* both documents are flattened to dotted leaf paths
  (``throughput.mxfp4_paged_tok_per_s``, ``kv.cache_ratio``, …),
* each path is matched (first hit wins, ``fnmatch`` patterns) against
  :data:`RULES`, which give a *direction* (which way is worse), a relative
  tolerance band, and a *severity*:

  - ``hard`` — deterministic facts of the build: schema/arch/family/config
    identity, cache-byte counts and compression ratios, FP4 bytes-ratio
    wins, spec acceptance on the self-proposer, prefix hit rate.  Any drift
    outside the (tight) band is a real behavior change → nonzero exit.
  - ``soft`` — wall-clock metrics (throughput, TTFT/TPOT, tick times) that
    are meaningful on dedicated hardware but noisy on shared CPU CI.
    Violations print a visible warning and fail only under ``--strict``.
  - ``info`` — reported in the delta table, never gated (pool occupancy
    shifts with legitimate scheduling changes; quant health is
    workload-dependent; profile FLOPs/bytes drift with XLA versions).

* nullable sections are handled explicitly: both-null is a match, a hard
  field going null (a parity measurement disappearing) is a hard failure,
  and newly-present fields are informational.

CLI::

    python -m repro_torch.serve.telemetry.regression fresh.json \
        [--baseline BENCH_serve.json] [--strict] [--json report.json]

Exit status: 0 clean (soft warnings allowed), 1 regression (hard, or any
with ``--strict``), 2 unreadable/incomparable inputs.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import numbers
from fnmatch import fnmatch

HARD, SOFT, INFO = "hard", "soft", "info"

# (dotted-path pattern, direction, relative tolerance, severity).
# direction: "exact" (any change fails), "lower_worse" (fail when the fresh
# value drops below baseline by more than tol), "higher_worse" (fail when it
# rises above by more than tol), "any" (fail when |rel delta| exceeds tol).
# First matching rule wins; unmatched numeric leaves default to INFO.
RULES: tuple[tuple[str, str, float, str], ...] = (
    # identity / parity — deterministic, hard
    ("schema", "exact", 0.0, HARD),
    ("arch", "exact", 0.0, HARD),
    ("family", "exact", 0.0, HARD),
    ("config.*", "exact", 0.0, HARD),
    ("kv.cache_bytes_dense", "exact", 0.0, HARD),
    ("kv.cache_bytes_mxfp4", "exact", 0.0, HARD),
    ("kv.bits_per_elem_mxfp4", "any", 1e-6, HARD),
    ("kv.cache_ratio", "lower_worse", 0.01, HARD),
    ("kv.decode_bytes_ratio_gather_over_paged", "lower_worse", 0.01, HARD),
    ("kv.prefill_bytes_ratio_gather_over_paged", "lower_worse", 0.01, HARD),
    ("spec.k", "exact", 0.0, HARD),
    ("spec.proposer", "exact", 0.0, HARD),
    ("spec.acceptance_rate", "lower_worse", 0.01, HARD),
    ("spec.tokens_per_decode_call", "lower_worse", 0.05, HARD),
    ("prefix.hit_rate", "lower_worse", 0.01, HARD),
    ("prefix.shared_tokens", "lower_worse", 0.01, HARD),
    ("sharding.tp_run.parity_vs_single", "lower_worse", 0.0, HARD),
    ("sharding.dp_run.parity_vs_single", "lower_worse", 0.0, HARD),
    # wall-clock — soft (CPU CI noise); bands sized for shared runners
    ("throughput.*", "lower_worse", 0.15, SOFT),
    ("latency.*", "higher_worse", 0.50, SOFT),
    ("tick.*", "higher_worse", 0.75, SOFT),
    ("prefix.*ttft*", "higher_worse", 0.50, SOFT),
    ("prefix.*tok_per_s", "lower_worse", 0.25, SOFT),
    ("sharding.*tok_per_s", "lower_worse", 0.25, SOFT),
    ("sharding.*speedup*", "lower_worse", 0.25, SOFT),
    # profile cost accounting — HLO facts, but they drift across XLA
    # versions; a *rise* in per-call cost is the interesting direction
    ("profile.*flops_per_call", "higher_worse", 0.10, SOFT),
    ("profile.*hbm_bytes_per_call", "higher_worse", 0.10, SOFT),
    # state-pool family A/B (schema v5): parity vs the dense-slot oracle and
    # the pooled state-bytes win are deterministic facts — hard; per-family
    # throughput is wall-clock — soft
    ("families.*.token_parity", "lower_worse", 0.0, HARD),
    ("families.*.state_bytes_ratio", "lower_worse", 0.02, HARD),
    ("families.*tok_per_s", "lower_worse", 0.25, SOFT),
    # everything else (pool occupancy, quant health, utilizations, walls,
    # counters-of-calls) — informational only
    ("*", "any", 0.0, INFO),
)


@dataclasses.dataclass
class Delta:
    """One compared leaf: baseline vs fresh plus the verdict."""

    path: str
    base: object
    fresh: object
    direction: str
    tol: float
    severity: str       # hard / soft / info
    status: str         # ok / warn / fail / info / new / gone
    rel: float | None   # signed relative delta where defined

    @property
    def failed(self) -> bool:
        return self.status == "fail"

    @property
    def warned(self) -> bool:
        return self.status == "warn"


def flatten(doc: dict, prefix: str = "") -> dict[str, object]:
    """Dotted-path → leaf value (numbers, strings, None).  Lists are left
    opaque (the bench schema has none at gate-relevant depth)."""
    out: dict[str, object] = {}
    for key, v in doc.items():
        path = f"{prefix}{key}"
        if isinstance(v, dict):
            out.update(flatten(v, f"{path}."))
        else:
            out[path] = v
    return out


def _rule_for(path: str) -> tuple[str, float, str]:
    for pat, direction, tol, severity in RULES:
        if fnmatch(path, pat):
            return direction, tol, severity
    return "any", 0.0, INFO


def _is_num(v) -> bool:
    return isinstance(v, numbers.Real) and not isinstance(v, bool)


def compare(baseline: dict, fresh: dict) -> list[Delta]:
    """Flatten both docs and judge every leaf in the union of their paths."""
    base_flat, fresh_flat = flatten(baseline), flatten(fresh)
    deltas: list[Delta] = []
    for path in sorted(set(base_flat) | set(fresh_flat)):
        direction, tol, severity = _rule_for(path)
        b = base_flat.get(path)
        f = fresh_flat.get(path)
        rel = None
        if path not in base_flat or (b is None and f is not None):
            status = "new"  # newly measured — informational
        elif path not in fresh_flat or (f is None and b is not None):
            # a measurement disappearing is itself a regression for gated
            # fields (a parity/ratio going null means the path is gone)
            status = "fail" if severity == HARD else (
                "warn" if severity == SOFT else "gone")
        elif b is None and f is None:
            status = "ok"
        elif direction == "exact" or not (_is_num(b) and _is_num(f)):
            status = "ok" if b == f else (
                "fail" if severity == HARD else
                "warn" if severity == SOFT else "info")
        else:
            rel = (f - b) / abs(b) if b else (0.0 if f == b else float("inf"))
            if direction == "lower_worse":
                bad = rel < -tol
            elif direction == "higher_worse":
                bad = rel > tol
            else:  # "any"
                bad = severity != INFO and abs(rel) > tol
            status = ("fail" if severity == HARD else
                      "warn" if severity == SOFT else "info") if bad else "ok"
        deltas.append(Delta(path, b, f, direction, tol, severity, status, rel))
    return deltas


def _fmt(v) -> str:
    if v is None:
        return "null"
    if _is_num(v) and not isinstance(v, int):
        return f"{v:.6g}"
    return str(v)


def render_table(deltas: list[Delta], *, show_ok: bool = False) -> str:
    """Human-readable delta table: failures first, then warnings, then (with
    ``show_ok``) everything else."""
    order = {"fail": 0, "warn": 1, "gone": 2, "new": 3, "info": 4, "ok": 5}
    rows = [d for d in deltas
            if show_ok or d.status not in ("ok", "info", "new", "gone")]
    shown = sorted(rows, key=lambda d: (order[d.status], d.path))
    if not shown:
        return "regression gate: all gated metrics within tolerance\n"
    widths = [max(len("metric"), *(len(d.path) for d in shown)),
              max(len("baseline"), *(len(_fmt(d.base)) for d in shown)),
              max(len("fresh"), *(len(_fmt(d.fresh)) for d in shown))]
    head = (f"{'metric':<{widths[0]}}  {'baseline':>{widths[1]}}  "
            f"{'fresh':>{widths[2]}}  {'delta':>9}  band        verdict")
    lines = [head, "-" * len(head)]
    for d in shown:
        rel = f"{d.rel:+.1%}" if d.rel is not None else "—"
        band = (f"{d.direction}±{d.tol:g}" if d.direction == "any"
                else f"{d.direction}:{d.tol:g}")
        mark = {"fail": "FAIL", "warn": "WARN", "gone": "gone",
                "new": "new", "info": "info", "ok": "ok"}[d.status]
        lines.append(f"{d.path:<{widths[0]}}  {_fmt(d.base):>{widths[1]}}  "
                     f"{_fmt(d.fresh):>{widths[2]}}  {rel:>9}  {band:<10}  "
                     f"{mark}")
    return "\n".join(lines) + "\n"


def gate(baseline: dict, fresh: dict, *, strict: bool = False,
         ) -> tuple[bool, list[Delta], str]:
    """Compare and verdict.  Returns ``(ok, deltas, report_text)`` — ``ok``
    is False on any hard failure, or on soft warnings when ``strict``."""
    deltas = compare(baseline, fresh)
    n_fail = sum(d.failed for d in deltas)
    n_warn = sum(d.warned for d in deltas)
    ok = n_fail == 0 and (n_warn == 0 or not strict)
    report = render_table(deltas)
    verdict = ("PASS" if ok else "FAIL")
    report += (f"\nregression gate: {verdict} — {n_fail} hard failure(s), "
               f"{n_warn} soft warning(s)"
               f"{' (strict: warnings fail)' if strict and n_warn else ''}\n")
    if n_warn and ok:
        report += ("soft warnings are wall-clock metrics on shared CI "
                   "hardware — investigate before trusting, gate with "
                   "--strict on dedicated runners\n")
    return ok, deltas, report


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(
        description="Compare a fresh BENCH_serve.json against the committed "
                    "baseline with per-metric tolerance bands.")
    ap.add_argument("fresh", help="freshly produced BENCH_serve.json")
    ap.add_argument("--baseline", default="BENCH_serve.json",
                    help="committed baseline (default: ./BENCH_serve.json)")
    ap.add_argument("--strict", action="store_true",
                    help="soft (wall-clock) violations also fail the gate")
    ap.add_argument("--json", dest="json_out", default=None,
                    help="also write the full delta list as JSON")
    args = ap.parse_args(argv)
    try:
        with open(args.baseline) as fh:
            baseline = json.load(fh)
        with open(args.fresh) as fh:
            fresh = json.load(fh)
    except (OSError, json.JSONDecodeError) as e:
        print(f"regression gate: cannot read inputs: {e}")
        return 2
    if not isinstance(baseline, dict) or not isinstance(fresh, dict):
        print("regression gate: inputs must be JSON objects")
        return 2
    ok, deltas, report = gate(baseline, fresh, strict=args.strict)
    print(report, end="")
    if args.json_out:
        with open(args.json_out, "w") as fh:
            json.dump([dataclasses.asdict(d) for d in deltas], fh, indent=1)
            fh.write("\n")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
