"""Schema versioning + validation for persisted telemetry artifacts.

Port of ``repro.serve.telemetry.schema`` (pure Python, copied): the schema
strings and specs are the reference's, so a snapshot or benchmark document
of either package passes either package's validators.

Two documents leave the process:

* the **metrics stream** — JSON-lines of registry snapshots
  (``registry.METRICS_SCHEMA``), one object per emit,
* the **benchmark baseline** (``BENCH_SCHEMA``), the serving benchmark's
  summary document, kept so the perf trajectory can be tracked.

Validators are hand-rolled (no jsonschema dependency) and return a list of
human-readable error strings — empty means valid.
"""

from __future__ import annotations

import json
import numbers

from repro_torch.serve.telemetry.registry import METRICS_SCHEMA

# v2: adds the "prefix" section (shared-prefix workload: hit rate, warm/cold
# TTFT, prefill tok/s) — null-filled when the benchmark skips that section
# v3: adds the nullable "sharding" section (multi-device serving: TP parity +
# TTFT/TPOT deltas, DP per-replica and aggregate tok/s, per-shard pool
# bytes) — null when the run is single-device or lacks forced host devices
# v4: adds the nullable "profile" section (per-phase HLO cost accounting
# from telemetry.profiling: FLOPs / HBM-proxy bytes per jitted call, mean
# roofline utilization and effective bandwidth over the primary run) — null
# when no step could be cost-accounted
# v5: adds the nullable "families" section (state-pool A/B over the
# non-attention families: per-family token parity vs the dense-slot oracle,
# pooled vs dense throughput, and per-decode-step state-byte traffic) —
# null when the benchmark runs without --family
BENCH_SCHEMA = "repro.bench_serve/v5"

_NUM = numbers.Real


class _Nullable:
    """Wrap an object spec: the whole section may be ``null`` (e.g. the
    ``sharding`` block on a single-device run), but when present it must
    conform to the wrapped spec."""

    def __init__(self, spec: dict):
        self.spec = spec


class _MapOf:
    """Object with *variable* keys (e.g. one block per benchmarked family),
    every value conforming to the wrapped spec.  The whole section may be
    ``null``; an empty object is valid (nothing was benchmarked)."""

    def __init__(self, spec: dict):
        self.spec = spec


def _check(errors: list, doc: dict, path: str, spec: dict) -> None:
    for key, want in spec.items():
        if key not in doc:
            errors.append(f"missing {path}{key}")
            continue
        v = doc[key]
        if isinstance(want, _MapOf):
            if v is None:
                continue
            if not isinstance(v, dict):
                errors.append(f"{path}{key}: expected object|null, "
                              f"got {type(v).__name__}")
                continue
            for sub, block in v.items():
                if not isinstance(block, dict):
                    errors.append(f"{path}{key}.{sub}: expected object, "
                                  f"got {type(block).__name__}")
                else:
                    _check(errors, block, f"{path}{key}.{sub}.", want.spec)
        elif isinstance(want, _Nullable):
            if v is None:
                continue
            if not isinstance(v, dict):
                errors.append(f"{path}{key}: expected object|null, "
                              f"got {type(v).__name__}")
            else:
                _check(errors, v, f"{path}{key}.", want.spec)
        elif isinstance(want, dict):
            if not isinstance(v, dict):
                errors.append(f"{path}{key}: expected object, got {type(v).__name__}")
            else:
                _check(errors, v, f"{path}{key}.", want)
        elif want is _NUM:
            if not isinstance(v, _NUM) or isinstance(v, bool):
                errors.append(f"{path}{key}: expected number, got {v!r}")
        elif want is str:
            if not isinstance(v, str):
                errors.append(f"{path}{key}: expected string, got {v!r}")
        elif want == "num_or_null":
            if v is not None and (not isinstance(v, _NUM) or isinstance(v, bool)):
                errors.append(f"{path}{key}: expected number|null, got {v!r}")


# Required shape of BENCH_serve.json.  Keys marked "num_or_null" may be null
# on dense-slot families (no paged pool / no spec section to measure).
_BENCH_SPEC = {
    "schema": str,
    "arch": str,
    "family": str,
    "config": {"n_requests": _NUM, "max_new": _NUM, "n_slots": _NUM},
    "throughput": {
        "mxfp4_paged_tok_per_s": _NUM,
        "dense_paged_tok_per_s": _NUM,
        "mxfp4_gather_tok_per_s": _NUM,
    },
    "latency": {
        "ttft_p50_s": _NUM, "ttft_p95_s": _NUM,
        "tpot_p50_s": "num_or_null", "tpot_p95_s": "num_or_null",
        "latency_p50_s": _NUM, "latency_p95_s": _NUM,
        "queue_wait_p50_s": _NUM,
    },
    "tick": {
        "decode_p50_s": "num_or_null", "decode_p95_s": "num_or_null",
        "prefill_p50_s": "num_or_null",
    },
    "kv": {
        "cache_bytes_dense": _NUM, "cache_bytes_mxfp4": _NUM,
        "cache_ratio": _NUM, "bits_per_elem_mxfp4": _NUM,
        "decode_bytes_ratio_gather_over_paged": "num_or_null",
        "prefill_bytes_ratio_gather_over_paged": "num_or_null",
    },
    "pool": {
        "occupancy_peak": _NUM,
        "free_page_watermark": _NUM,
    },
    "spec": {
        "k": _NUM,
        "proposer": str,
        "acceptance_rate": "num_or_null",
        "tokens_per_decode_call": "num_or_null",
    },
    "quant_health": {
        "clip_fraction_k": "num_or_null",
        "clip_fraction_v": "num_or_null",
        "zero_fraction_k": "num_or_null",
        "scale_hist_nonzero_bins": "num_or_null",
        "scale_code_min": "num_or_null",
        "scale_code_max": "num_or_null",
    },
    "prefix": {
        "hit_rate": "num_or_null",
        "shared_tokens": "num_or_null",
        "cow_pages": "num_or_null",
        "warm_ttft_mean_s": "num_or_null",
        "cold_ttft_mean_s": "num_or_null",
        "warm_ttft_p95_s": "num_or_null",
        "cold_ttft_p95_s": "num_or_null",
        "warm_prefill_tok_per_s": "num_or_null",
        "cold_prefill_tok_per_s": "num_or_null",
    },
    # whole section is null when the run is single-device (tp==dp==1), the
    # family is not paged, or the process has too few devices to shard
    "sharding": _Nullable({
        "tp": _NUM,
        "dp": _NUM,
        "devices": _NUM,
        "single": {
            "decode_tok_per_s": _NUM,
            "ttft_p50_s": _NUM,
            "tpot_p50_s": "num_or_null",
            "wall_sec": _NUM,
        },
        "tp_run": _Nullable({
            "decode_tok_per_s": _NUM,
            "ttft_p50_s": _NUM,
            "tpot_p50_s": "num_or_null",
            "wall_sec": _NUM,
            "pool_bytes_per_shard": _NUM,
            "parity_vs_single": _NUM,  # 1.0 exact / 0.0 mismatch
            "ttft_p50_delta_s": "num_or_null",
            "tpot_p50_delta_s": "num_or_null",
        }),
        "dp_run": _Nullable({
            "aggregate_decode_tok_per_s": _NUM,
            "speedup_vs_one_replica": _NUM,
            "parity_vs_single": _NUM,
            "pool_bytes_per_shard": _NUM,
            "wall_sec": _NUM,
        }),
    }),
    # per-phase device cost accounting of the primary (mxfp4+paged) run;
    # each phase block is null when that phase never ran (e.g. "verify"
    # without speculation) and the whole section null when nothing lowered
    "profile": _Nullable({
        "peak_flops": _NUM,
        "peak_bw": _NUM,
        "prefill": _Nullable(_PROFILE_PHASE_SPEC := {
            "flops_per_call": _NUM,
            "hbm_bytes_per_call": _NUM,
            "calls": _NUM,
            "wall_s": _NUM,
            "roofline_util_mean": "num_or_null",
            "effective_bw_mean": "num_or_null",
        }),
        "decode": _Nullable(_PROFILE_PHASE_SPEC),
        "verify": _Nullable(_PROFILE_PHASE_SPEC),
    }),
    # state-pool A/B over the non-attention families (--family): one block
    # per benchmarked arch (key = arch slug), null when the section was not
    # run.  token_parity is 1.0 when the pooled engine (kv_dtype="dense")
    # is token-exact vs the DenseSlotCache oracle on the same workload;
    # state bytes are per-decode-step HBM traffic of the mxfp4 pool vs the
    # oracle's dense per-slot caches
    "families": _MapOf({
        "family": str,
        "token_parity": _NUM,
        "pool_tok_per_s": _NUM,
        "oracle_tok_per_s": _NUM,
        "state_bytes_per_step_pool": _NUM,
        "state_bytes_per_step_dense": _NUM,
        "state_bytes_ratio": _NUM,
        "cache_bytes_pool": _NUM,
        "cache_bytes_dense": _NUM,
    }),
}


def validate_bench(doc: dict) -> list[str]:
    errors: list[str] = []
    if not isinstance(doc, dict):
        return [f"expected a JSON object, got {type(doc).__name__}"]
    _check(errors, doc, "", _BENCH_SPEC)
    if not errors and doc["schema"] != BENCH_SCHEMA:
        errors.append(f"schema {doc['schema']!r} != {BENCH_SCHEMA!r}")
    return errors


def validate_bench_file(path: str) -> dict:
    """Load + validate; raises ``ValueError`` listing every violation.
    Returns the parsed doc on success."""
    with open(path) as fh:
        doc = json.load(fh)
    errors = validate_bench(doc)
    if errors:
        raise ValueError(f"{path} failed {BENCH_SCHEMA} validation:\n  "
                         + "\n  ".join(errors))
    return doc


_SNAPSHOT_SPEC = {
    "schema": str,
    "t": _NUM,
    "meta": {},
    "counters": {},
    "gauges": {},
    "histograms": {},
    "binned": {},
    "rates": {},
}


def validate_snapshot(obj: dict) -> list[str]:
    errors: list[str] = []
    if not isinstance(obj, dict):
        return [f"expected a JSON object, got {type(obj).__name__}"]
    _check(errors, obj, "", _SNAPSHOT_SPEC)
    if not errors and obj["schema"] != METRICS_SCHEMA:
        errors.append(f"schema {obj['schema']!r} != {METRICS_SCHEMA!r}")
    if not errors:
        for name, v in obj["counters"].items():
            if not isinstance(v, int) or v < 0:
                errors.append(f"counter {name}: expected int >= 0, got {v!r}")
        for name, s in obj["histograms"].items():
            if "count" not in s:
                errors.append(f"histogram {name}: missing count")
    return errors


def validate_metrics_file(path: str) -> int:
    """Validate every line of a JSONL metrics stream; raises on the first
    bad line, returns the number of snapshots otherwise."""
    n = 0
    with open(path) as fh:
        for i, line in enumerate(fh, 1):
            if not line.strip():
                continue
            errors = validate_snapshot(json.loads(line))
            if errors:
                raise ValueError(f"{path}:{i} failed {METRICS_SCHEMA} "
                                 f"validation:\n  " + "\n  ".join(errors))
            n += 1
    if n == 0:
        raise ValueError(f"{path}: empty metrics stream")
    return n
