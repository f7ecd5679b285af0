"""The port's engine profiler and step-cost counter.

* The Chrome-trace sink renders equal events into the same document as the
  reference's, timestamps monotonic on every lane; both packages'
  ``validate_trace`` accept it and reject broken documents with equal
  errors.
* A tiny decode call's counted FLOPs equal the hand count from the config:
  2·B·(every linear's K·N) + 2·B·d·V (the head) + 4·Hq·hd a visible
  position (the paged attention), through the kernel wrappers (Quartet) and
  through PyTorch's own products (bf16) alike, and the wrappers' bytes are
  counted once, not again through their plain versions' ops.
* Per-call costs are deterministic: two engines on one workload count equal
  costs.
* Profiling on is bit-identical to off in tokens and pool bytes (the paged
  backend with self-speculation, the gather backend), the tick that counted
  a call is left out of the utilization means, and ``profile_report``'s
  block passes both packages' benchmark validators.
"""

import json
import types

import numpy as np
import pytest
import torch

from repro.serve.telemetry import profiling as JPR
from repro.serve.telemetry import schema as JS
from repro_torch.configs import get_reduced_config
from repro_torch.convert import init_params
from repro_torch.kernels import ops
from repro_torch.launch.roofline import StepCostCounter, model_flops, roofline_terms
from repro_torch.launch.serve_engine import kernel_config
from repro_torch.models import build_model
from repro_torch.serve import Engine, EngineConfig, SpecConfig, TelemetryConfig
from repro_torch.serve import paged_cache as P
from repro_torch.serve.steps import build_paged_steps
from repro_torch.serve.telemetry import profiling as TPR
from repro_torch.serve.telemetry import schema as TS


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run many small ops, which several
    threads a worker only slow down when the suite runs on several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def qwen():
    cfg = kernel_config(get_reduced_config("qwen3-1.7b"))
    return cfg, build_model(cfg), init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _sink_events(PR):
    sink = PR.TraceEventSink(pid=3)
    sink.complete("tick", "tick", 0.5, 0.01, args={"step": 1})
    sink.complete("decode", "phase", 0.2, 0.003)
    sink.instant("jit_compile:decode_all", "compile", 0.2, args={"compiled_variants": 1})
    sink.thread_name(PR.TID_REQ_BASE + 4, "req 4")
    sink.complete("queued", "request", 0.1, 0.1, PR.TID_REQ_BASE + 4, {"rid": 4})
    sink.complete("decode", "request", 0.3, -1.0, PR.TID_REQ_BASE + 4)
    return sink


def test_trace_sink_equal_and_monotonic(tmp_path):
    tdoc = TPR.write_trace(str(tmp_path / "t.json"), [_sink_events(TPR)])
    jdoc = JPR.write_trace(str(tmp_path / "j.json"), [_sink_events(JPR)])
    assert tdoc == jdoc
    assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()
    assert TPR.validate_trace(tdoc) == JPR.validate_trace(tdoc) == []
    assert TPR.validate_trace_file(str(tmp_path / "t.json")) == tdoc
    lanes = {}
    for ev in tdoc["traceEvents"]:
        if ev["ph"] != "M":
            lane = (ev["pid"], ev["tid"])
            assert ev["ts"] >= lanes.get(lane, 0.0)
            lanes[lane] = ev["ts"]


@pytest.mark.parametrize("broken", [
    {}, {"traceEvents": []},
    {"traceEvents": [{"name": "a", "ph": "X", "pid": 0, "ts": 5, "dur": -1}]},
    {"traceEvents": [{"name": "a", "ph": "X", "pid": 0, "tid": 0, "ts": 5, "dur": 1},
                     {"name": "b", "ph": "i", "pid": 0, "tid": 0, "ts": 2}]},
    {"traceEvents": [{"ph": "X", "pid": 0, "tid": 0, "ts": -3, "dur": 1}]},
])
def test_validate_trace_rejects_broken(broken, tmp_path):
    errs = JPR.validate_trace(broken)
    assert errs and TPR.validate_trace(broken) == errs
    (tmp_path / "b.json").write_text(json.dumps(broken))
    with pytest.raises(ValueError):
        TPR.validate_trace_file(str(tmp_path / "b.json"))


@pytest.mark.parametrize("method", ["quartet", "bf16"])
def test_decode_call_flops_equal_hand_count(qwen, method):
    cfg, model, params = qwen
    B, ps, npp = 3, 8, 3
    steps = build_paged_steps(model, method=method, page_size=ps)
    cache = P.PagedCache(cfg, n_slots=B, pages_per_slot=npp, page_size=ps, device="cpu")
    for slot in range(B):
        cache.alloc(slot, 20)
    positions = np.array([4, 17, 0], np.int32)
    mask = np.array([True, True, False])
    args = (params, torch.tensor([[5], [9], [1]], dtype=torch.int32),
            torch.from_numpy(positions), cache.pool, torch.from_numpy(cache.tables),
            torch.from_numpy(mask))
    plain = steps.decode_all.fn(*args)
    ops.reset_launch_counts()
    with StepCostCounter() as counter:
        counted = steps.decode_all.fn(*args)
    assert torch.equal(counted, plain)
    d, V, hd = cfg.d_model, cfg.vocab_size, cfg.head_dim_
    visible = [int(p) + 1 if m else 1 for p, m in zip(positions, mask)]  # masked: position 0
    hand = (2 * B * cfg.n_params() + 2 * B * d * V
            + cfg.num_layers * sum(4 * cfg.num_heads * hd * n for n in visible))
    assert counter.flops == hand
    shape = types.SimpleNamespace(seq_len=1, global_batch=B, kind="decode")
    assert model_flops(cfg, shape, False) == 2 * B * cfg.n_params()
    # the pool write: K and V of B tokens a layer, each read once and packed,
    # 8 bytes of ids a token, counted once through B4a's wrapper
    assert counter.hbm_bytes > cfg.num_layers * 2 * B * cfg.num_kv_heads * hd * 4.5
    terms = roofline_terms({"flops": counter.flops, "mem_bytes": counter.hbm_bytes})
    assert terms["dominant"] == "memory" and terms["collective_s"] == 0.0


def _profiled_run(model, params, vocab, backend="paged", spec=None, tel=None):
    eng = Engine(model, params, EngineConfig(n_slots=2, max_len=48, page_size=8,
                                             prefill_chunk=8, decode_backend=backend,
                                             spec=spec, telemetry=tel))
    rng = np.random.default_rng(7)
    reqs = [eng.submit(rng.integers(1, vocab, size=5 + 6 * i), max_new=6, arrival_time=0.0)
            for i in range(3)]
    t = 0.0
    while eng.sched.pending:
        eng.step(now=t)
        t += 0.01
    return eng, [r.tokens for r in reqs], t


def test_costs_deterministic_and_profile_report_valid(qwen):
    cfg, model, params = qwen
    a, _, ta = _profiled_run(model, params, cfg.vocab_size, tel=TelemetryConfig(profile=True))
    b, _, _ = _profiled_run(model, params, cfg.vocab_size, tel=TelemetryConfig(profile=True))
    pa, pb = a.telemetry.profiler, b.telemetry.profiler
    assert pa.phase_costs() == pb.phase_costs()
    assert set(pa.phase_costs()) == {"decode_all", "prefill_all"}
    assert pa.step_cost("verify_all") is None
    util = pa.utilization_summary()
    decode = util["decode"]
    assert decode["calls"] == a.telemetry.registry.counter("decode_calls").value
    assert decode["flops_per_call"] == pa.step_cost("decode_all").flops
    # the first decode tick counted its call and is left out of the means
    assert decode["wall_s"] < a.telemetry.snapshot()["histograms"]["decode_tick_s"]["sum"]
    assert util["verify"] is None
    report = TPR.profile_report(a, a.telemetry.snapshot(ta))
    assert report["decode"]["calls"] == decode["calls"]
    doc = {"profile": report}
    spec = {"profile": JS._BENCH_SPEC["profile"]}
    errs = []
    JS._check(errs, doc, "", spec)
    assert errs == []
    TS._check(errs, doc, "", {"profile": TS._BENCH_SPEC["profile"]})
    assert errs == []
    plain = Engine(model, params, EngineConfig(n_slots=2, max_len=48))
    assert TPR.profile_report(plain, plain.telemetry.snapshot()) is None


@pytest.mark.parametrize("backend,spec", [("paged", SpecConfig(k=3, proposer="self")),
                                          ("gather", None)])
def test_profiling_on_is_bit_identical_to_off(qwen, tmp_path, backend, spec):
    cfg, model, params = qwen
    off, off_tokens, _ = _profiled_run(model, params, cfg.vocab_size, backend, spec)
    on, on_tokens, t = _profiled_run(
        model, params, cfg.vocab_size, backend, spec,
        TelemetryConfig(profile_trace_path=str(tmp_path / "trace.json")))
    assert on_tokens == off_tokens
    for k, v in off.cache.pool.items():
        assert torch.equal(on.cache.pool[k], v), k
    assert on.compile_counts() == off.compile_counts()
    on.telemetry.finalize(t)
    doc = TPR.validate_trace_file(str(tmp_path / "trace.json"))
    names = {ev["name"] for ev in doc["traceEvents"]}
    assert {"tick", "prefill", "queued", "decode"} <= names
    phase = "verify" if spec else "decode"
    assert phase in names
    costs = on.telemetry.profiler.phase_costs()
    assert costs[f"{phase}_all"]["flops"] > 0
    if backend == "gather":  # [1, C] chunks and [1, 1] remainders: two shapes
        assert on.compile_counts()["prefill_chunk"] == 2
        assert len(on.telemetry.profiler._costs["prefill_chunk"]) == 2
