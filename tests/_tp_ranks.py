"""Ranks of a gloo world for the port's multi-device serving tests
(``tests/test_torch_serve_tp*.py``, ``tests/test_torch_replica.py``).

:func:`start` launches ``world`` processes (``python tests/_tp_ranks.py``),
each joining a gloo world over a ``FileStore`` under the test's
``tmp_path`` (no TCP ports, so xdist workers cannot collide), running one
function of this module on its rank and pickling the result.  The caller
computes the one-device engine meanwhile, then :meth:`Ranks.join` waits
with a hard limit: a rank that raises or exits non-zero fails the test
with its traceback, and a rank still running at the limit is killed and
fails it too, so a test never hangs the suite.

The rank functions and the one-device runs share :func:`serve`, so both
sides serve the same workload on the same weights.  This module imports
torch and the port only: each rank starts a fresh interpreter, and leaving
JAX out keeps its start short.
"""

from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
import traceback

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(os.path.dirname(HERE), "src")
JOIN_LIMIT_S = 120
GLOO_TIMEOUT_S = 60

# the serving workload of the reference's sharded tests: 4 prompts of 12-15
# tokens sharing an 8-token prefix, 8 new tokens, 2 slots, pages of 8
N_PROMPTS, MAX_NEW = 4, 8
ENGINE = dict(n_slots=2, max_len=64, page_size=8, kv_dtype="mxfp4", prefill_chunk=8)
KEY = {"encdec": "source_embeds", "vlm": "image_embeds"}


class Ranks:
    """The processes of one world; :meth:`join` returns each rank's result."""

    def __init__(self, procs, out: str, limit_s: float):
        self.procs, self.out, self.limit_s = procs, out, limit_s
        self.t0 = time.monotonic()

    def join(self) -> list:
        deadline = self.t0 + self.limit_s
        try:
            for p in self.procs:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            raise RuntimeError(f"ranks still running after {self.limit_s} s: killed") from None
        finally:
            for p in self.procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        results, failed = [], []
        for r, p in enumerate(self.procs):
            with open(f"{self.out}.{r}", "rb") as fh:
                ok, value = pickle.load(fh) if os.path.getsize(fh.name) else (False, "no result")
            if p.returncode != 0 or not ok:
                failed.append(f"rank {r} exited {p.returncode}:\n{value}")
            results.append(value)
        if failed:
            raise RuntimeError("\n".join(failed))
        return results


def start(tmp_path, world: int, fn: str, *args, gloo_timeout_s: float = GLOO_TIMEOUT_S,
          limit_s: float = JOIN_LIMIT_S, script: str | None = None) -> Ranks:
    """Launch ``world`` ranks, each running ``fn(*args)`` of this module (or
    of ``script``, a helper module whose main calls :func:`_rank_main`)."""
    d = str(tmp_path)
    out = os.path.join(d, f"{fn}.out")
    with open(os.path.join(d, f"{fn}.args"), "wb") as fh:
        pickle.dump(args, fh)
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([SRC, HERE]), OMP_NUM_THREADS="1")
    procs = []
    for r in range(world):
        open(f"{out}.{r}", "wb").close()
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(script or __file__), str(r), str(world), d, fn,
             str(gloo_timeout_s)], env=env))
    return Ranks(procs, out, limit_s)


def _rank_main(rank: int, world: int, d: str, fn: str, gloo_timeout_s: float,
               namespace: dict | None = None) -> int:
    torch.set_num_threads(1)
    from repro_torch.launch.mesh import init_distributed

    out = os.path.join(d, f"{fn}.out.{rank}")
    try:
        with open(os.path.join(d, f"{fn}.args"), "rb") as fh:
            args = pickle.load(fh)
        store = torch.distributed.FileStore(os.path.join(d, f"{fn}.store"), world)
        init_distributed(device="cpu", rank=rank, world_size=world, store=store,
                         timeout_s=gloo_timeout_s)
        result = (True, (namespace or globals())[fn](*args))
        code = 0
    except BaseException:
        result, code = (False, traceback.format_exc()), 1
    with open(out, "wb") as fh:
        pickle.dump(result, fh)
    if code == 0:
        torch.distributed.destroy_process_group()
    return code


# ---------------------------------------------------------------------------
# the workload, on one device or on a rank
# ---------------------------------------------------------------------------

_MODELS: dict = {}


def setup(arch: str):
    """(cfg, model, params) of the reduced arch (the VLM's gates set)."""
    if arch not in _MODELS:
        from repro_torch.configs import get_reduced_config
        from repro_torch.convert import init_params
        from repro_torch.models import build_model

        cfg = get_reduced_config(arch)
        params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
        if cfg.family == "vlm":
            params["cross_layers"]["gate_attn"].copy_(torch.tensor([0.5, -0.7]))
            params["cross_layers"]["gate_mlp"].copy_(torch.tensor([-0.3, 0.9]))
        _MODELS[arch] = cfg, build_model(cfg), params
    return _MODELS[arch]


def prompts(cfg, n: int = N_PROMPTS) -> list[np.ndarray]:
    rng = np.random.default_rng(0)
    ps = [rng.integers(0, cfg.vocab_size, 12 + i).astype(np.int32) for i in range(n)]
    for i in range(1, n):  # a shared 8-token prefix exercises aliasing and copy-on-write
        ps[i][:8] = ps[0][:8]
    return ps


def extra(cfg, seed: int) -> dict | None:
    """A cross family's conditioning (bf16 standard normals from ``seed``)."""
    if cfg.family not in KEY:
        return None
    n = cfg.max_source_len if cfg.family == "encdec" else cfg.num_image_tokens
    x = np.random.default_rng(seed).standard_normal((1, n, cfg.d_model)).astype(np.float32)
    return {KEY[cfg.family]: torch.from_numpy(x).to(torch.bfloat16)}


def serve(arch: str, backend: str | None, joint: bool, tp: int = 1, dp: int = 1,
          telemetry=None, scramble: bool = False, method: str = "quartet"):
    """Drain the workload on ``make_engine``; returns (tokens per request in
    rid order, the engine).  ``joint`` turns on self-speculation (k 2, paged
    backend) and the prefix cache together, as the reference's sweep does,
    with the allocator's audit and the ranks' schedule check every tick;
    ``scramble`` gives a rank other than 0 other weights first, so only
    the broadcast from the group's first rank makes them equal the one
    device's."""
    from repro_torch.serve import EngineConfig, ShardingConfig, SpecConfig, make_engine

    cfg, model, params = setup(arch)
    if scramble and torch.distributed.get_rank() != 0:
        params = _scrambled(params)
    ec = EngineConfig(**ENGINE, decode_backend=backend, method=method,
                      sharding=ShardingConfig(tp, dp) if tp * dp > 1 else None,
                      spec=SpecConfig(k=2, proposer="self") if joint and backend == "paged"
                      else None,
                      prefix_cache=joint, debug_cache=joint, telemetry=telemetry)
    eng = make_engine(model, params, ec)
    for i, p in enumerate(prompts(cfg)):
        eng.submit(p, MAX_NEW, extra=extra(cfg, i % 2), arrival_time=0.0)
    done = eng.drain()
    return [r.tokens for r in sorted(done, key=lambda r: r.rid)], eng


def _scrambled(params):
    from repro_torch.tree import tree_map

    g = torch.Generator().manual_seed(1000 + torch.distributed.get_rank())
    return tree_map(lambda t: torch.randn(t.shape, generator=g).to(t.dtype)
                    if t.is_floating_point() else t.clone(), params)


def pools(eng) -> dict:
    """The engine's pool leaves (a state pool's KV and cross planes by
    plane), cloned."""
    if eng.backend == "statepool":
        return {f"{kind}/{k}": v.clone() for kind, p in eng.cache.planes()
                if hasattr(p, "tables") for k, v in p.pool.items()}
    return {k: v.clone() for k, v in eng.cache.pool.items()}


HEALTH = ("kv_clip_fraction_k", "kv_clip_fraction_v", "kv_zero_fraction_k",
          "kv_zero_fraction_v", "cross_clip_fraction_k", "cross_zero_fraction_v")


def health(eng) -> dict:
    """The pool-health gauges, scale histograms and sample count the
    engine's telemetry holds."""
    snap = eng.telemetry.registry.snapshot(0.0)
    out = {k: snap["gauges"].get(k) for k in HEALTH}
    out["samples"] = snap["counters"]["quant_health_samples"]
    out["scale_hist"] = {k: v for k, v in snap.get("binned", {}).items()}
    return out


def sweep(tmp_path_factory, cases: list, method: str = "quartet", health_case=None):
    """The TP 2 sweep of a test file: ``cases`` (arch, backend, joint)
    served on two ranks while this process serves them at TP 1.  Returns
    (TP 1 results by case, each rank's results by case)."""
    from repro_torch.serve import TelemetryConfig

    ranks = start(tmp_path_factory.mktemp("tp"), 2, "tp_sweep", cases, 2, health_case, method)
    base = {}
    for case in cases:
        tel = TelemetryConfig(quant_stride=1) if case == health_case else None
        toks, eng = serve(*case, telemetry=tel, method=method)
        base[case] = {"tokens": toks, "eng": eng, "health": health(eng) if tel else None}
    return base, ranks.join()


def case_id(case) -> str:
    return f"{case[1] or 'statepool'}-{'spec+prefix' if case[2] else 'plain'}"


def one_rank_of_two(rank: int):
    """A tp-2 placement that holds no group, for slicing a one-device pool
    as ``rank`` holds it (``Placement.shard_pool``)."""
    from repro_torch.serve import Placement

    p = Placement()
    p.tp, p.rank = 2, rank
    p.mesh = type("Sizes", (), {"shape": {"model": 2}, "axis_names": ("model",)})()
    return p


def assert_tokens_equal(swept, case) -> None:
    """Every rank's tokens equal TP 1's bit for bit."""
    base, ranks = swept
    for r in ranks:
        assert r[case]["tokens"] == base[case]["tokens"]


def assert_pools_are_head_slices(swept, case) -> None:
    """Each rank holds its block of every pool (or plane) leaf's heads, bit
    for bit the one-device pool's, a sharded leaf Hkv/2 heads of it; the
    two ranks are the two blocks, and the pool's bytes are the whole
    pool's."""
    base, ranks = swept
    eng = base[case]["eng"]
    planes = ([(kind, p) for kind, p in eng.cache.planes() if hasattr(p, "tables")]
              if eng.backend == "statepool" else [(None, eng.cache)])
    assert sorted(r[case]["rank"] for r in ranks) == [0, 1]
    for r in ranks:
        got = r[case]["pool"]
        assert len(got) == sum(len(p.pool) for _, p in planes)
        for kind, plane in planes:
            want = one_rank_of_two(r[case]["rank"]).shard_pool(plane.pool)
            for k, v in want.items():
                assert v.shape[3] == plane.kv_heads // 2, (kind, k)
                assert torch.equal(got[k if kind is None else f"{kind}/{k}"], v), (kind, k)
        assert r[case]["cache_bytes"] == eng.cache_bytes()
        assert r[case]["rank_bytes"] * 2 == eng.cache_bytes()


HISTS = ("tick_s", "decode_tick_s", "ttft_s")


def replica_runs(tmp_path_factory, arch: str, tp: int, dp: int, profile: bool = True):
    """The workload on ``tp x dp`` replica ranks (``replicas``) while this
    process serves it on one device: (one device's tokens, each rank's
    result, the trace's path, None without ``profile``)."""
    d = tmp_path_factory.mktemp(f"tp{tp}xdp{dp}")
    path = str(d / "trace.json") if profile else None
    ranks = start(d, tp * dp, "replicas", arch, tp, dp, path)
    base, _ = serve(arch, "paged", True)
    return base, ranks.join(), None if path is None else d / "trace.json"


def assert_replicas_token_exact(runs) -> None:
    base, results, _ = runs
    for r in results:
        assert r["tokens"] == base


def assert_rids_and_replicas(runs, tp: int) -> None:
    """Rids unique and in submission order on every rank, both replicas
    served, every rank merged the same view."""
    results = runs[1]
    for rank, r in enumerate(results):
        assert r["rids"] == sorted(r["rids"]) == list(range(N_PROMPTS))
        assert set(r["replica_of"]) == {0, 1}
        assert r["replica"] == rank // tp
        assert len(r["busy_s"]) == 2 and all(b > 0 for b in r["busy_s"])
        assert r == {**results[0], "replica": r["replica"], "mine": r["mine"],
                     "busy_s": r["busy_s"]}


def assert_aggregate_pools(runs, tp: int) -> None:
    """The merged snapshot sums the replicas' counters and pools their
    histograms (counts and sums of both replicas' samples)."""
    results = runs[1]
    firsts = [results[0], results[tp]]  # each replica's first rank
    agg = results[0]["agg"]
    assert agg["replicas"] == 2
    assert agg["counters"]["engine_ticks"] == sum(f["mine"]["ticks"] for f in firsts)
    assert agg["counters"]["decode_calls"] == sum(f["mine"]["decode_calls"] for f in firsts)
    for h in HISTS:
        assert agg["histograms"][h]["count"] == sum(f["mine"]["hist"][h][0] for f in firsts)
        want = sum(f["mine"]["hist"][h][1] for f in firsts)
        assert abs(agg["histograms"][h]["sum"] - want) <= 1e-9 * max(1.0, abs(want))
    assert agg["histograms"]["tick_s"]["count"] > 0


def assert_one_trace(runs) -> None:
    """One valid trace document with a process lane per replica."""
    from repro_torch.serve.telemetry.profiling import validate_trace_file

    _, results, path = runs
    assert all(r["trace"] == str(path) for r in results)
    doc = validate_trace_file(str(path))
    payload = [e for e in doc["traceEvents"] if e["ph"] != "M"]
    assert {e["pid"] for e in payload} == {0, 1}
    assert {"tick", "phase", "request"} <= {e.get("cat") for e in payload}


# ---------------------------------------------------------------------------
# rank functions
# ---------------------------------------------------------------------------


def tp_sweep(cases: list, tp: int, health_case=None, method: str = "quartet") -> dict:
    """Each case (arch, backend, joint) served at ``tp``: tokens, this
    rank's pool leaves, its head index, the pool's bytes, and for
    ``health_case`` the pool health sampled every tick."""
    from repro_torch.serve import TelemetryConfig

    out = {}
    for case in cases:
        tel = TelemetryConfig(quant_stride=1) if case == health_case else None
        toks, eng = serve(*case, tp=tp, telemetry=tel, scramble=True, method=method)
        out[case] = {"tokens": toks, "pool": pools(eng), "rank": eng.placement.rank,
                     "cache_bytes": eng.cache_bytes(), "rank_bytes": eng.rank_bytes(),
                     "health": health(eng) if tel is not None else None}
    return out


def replicas(arch: str, tp: int, dp: int, trace_path: str | None) -> dict:
    """The workload on ``tp x dp`` replicas (profiled into ``trace_path``
    when given): tokens, the merged requests, the aggregate snapshot beside
    each replica's own registry numbers, and the trace file written once."""
    from repro_torch.serve import TelemetryConfig

    toks, eng = serve(arch, "paged", True, tp=tp, dp=dp,
                      telemetry=TelemetryConfig(profile_trace_path=trace_path))
    done = eng.completed
    agg = eng.aggregate_telemetry()
    reg = eng.engine.telemetry.registry
    mine = {"ticks": reg.counter("engine_ticks").value,
            "decode_calls": reg.counter("decode_calls").value,
            "hist": {h: (reg.histogram(h).count, reg.histogram(h).total) for h in HISTS}}
    return {"tokens": toks, "rids": [r.rid for r in done],
            "replica_of": [r.replica for r in done], "replica": eng.replica,
            "agg": {"replicas": agg["replicas"], "counters": agg["counters"],
                    "histograms": {h: {"count": agg["histograms"][h]["count"],
                                       "sum": agg["histograms"][h]["sum"]}
                                   for h in HISTS}},
            "mine": mine, "busy_s": eng.busy_s, "trace": eng.write_profile(),
            "cache_bytes": eng.cache_bytes()}


def failing_rank(arch: str) -> None:
    """A TP 2 engine whose rank 1 fails before its first step: rank 0 must
    not wait for it past the group's timeout."""
    from repro_torch.serve import Engine, EngineConfig, ShardingConfig

    cfg, model, params = setup(arch)
    eng = Engine(model, params, EngineConfig(**ENGINE, sharding=ShardingConfig(2)))
    eng.submit(prompts(cfg)[0], 2)
    if torch.distributed.get_rank() == 1:
        raise RuntimeError("rank 1 fails on purpose")
    eng.drain()


if __name__ == "__main__":
    sys.exit(_rank_main(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3], sys.argv[4],
                        float(sys.argv[5])))
