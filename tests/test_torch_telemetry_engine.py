"""PyTorch port vs the JAX reference: the engine's telemetry.

Both packages' reduced qwen3-1.7b engines (the port's weights converted
from the reference's with ``params_from_jax``; ``method="bf16"``, ROADMAP
C1) take the reference telemetry test's schedule — 2 slots, pages of 8,
chunks of 8, three prompts of 5, 8 and 11 tokens, 5 new tokens each — on
the virtual clock ``now = 0.01·step``, in lockstep.  After every tick the
registry counters, the scheduler and pool gauges and the ``jit_compiled_*``
gauges (the port counts step-shape signatures: a fixed-shape engine reads 1
for each step it used) must be equal, and at the end the traces' derived
times and the latency histograms too.  Every ``CATALOG`` name is in the
port's snapshot under its kind before the first step.  Telemetry fully on
(every sink, pool health every tick, the profiler) is bit-identical to off
in tokens and pool bytes, and a reduced zamba2-7b state-pool engine reports
``kv`` and ``state`` health, a reduced whisper-tiny one ``kv`` and
``cross`` health.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jget_reduced
from repro.models import build_model as jbuild
from repro.serve import Engine as JEngine
from repro.serve import EngineConfig as JEngineConfig
from repro.serve.telemetry import CATALOG as JCATALOG
from repro.serve.telemetry.schema import validate_snapshot as jvalidate_snapshot
from repro_torch.configs import get_reduced_config
from repro_torch.convert import init_params, params_from_jax
from repro_torch.launch.serve_engine import make_extra
from repro_torch.models import build_model
from repro_torch.serve import Engine, EngineConfig, TelemetryConfig
from repro_torch.serve.telemetry import CATALOG
from repro_torch.serve.telemetry.profiling import validate_trace_file
from repro_torch.serve.telemetry.schema import validate_metrics_file, validate_snapshot

SECTION = {"counter": "counters", "gauge": "gauges", "histogram": "histograms",
           "binned": "binned", "ewma": "rates"}
SCHEDULE_GAUGES = ("queue_depth", "slots_active", "slots_prefilling", "slots_decoding",
                   "pool_pages_total", "pool_pages_free", "pool_pages_free_watermark",
                   "pool_occupancy", "pool_occupancy_peak", "kv_cache_bytes",
                   "jit_compiled_decode_all", "jit_compiled_prefill_all",
                   "jit_compiled_prefill_chunk", "jit_compiled_verify_all")
ECFG = dict(n_slots=2, max_len=48, page_size=8, prefill_chunk=8, method="bf16")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run many small ops, which several
    threads a worker only slow down when the suite runs on several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    jcfg, tcfg = jget_reduced("qwen3-1.7b"), get_reduced_config("qwen3-1.7b")
    jm, tm = jbuild(jcfg), build_model(tcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    return jm, jp, tm, params_from_jax(jax.device_get(jp), tcfg, "cpu")


def _submit(eng, vocab, n_requests=3, max_new=5):
    rng = np.random.default_rng(7)
    return [eng.submit(rng.integers(1, vocab, size=5 + 3 * i), max_new=max_new,
                       arrival_time=0.0) for i in range(n_requests)]


def _drive(eng, t=0.0):
    while eng.sched.pending:
        eng.step(now=t)
        t += 0.01
    return t


def _schedule_view(snap):
    return snap["counters"], {k: snap["gauges"][k] for k in SCHEDULE_GAUGES}


def test_counters_gauges_and_traces_equal_reference(pair):
    jm, jp, tm, tp = pair
    jeng, teng = JEngine(jm, jp, JEngineConfig(**ECFG)), Engine(tm, tp, EngineConfig(**ECFG))
    vocab = tm.cfg.vocab_size
    _submit(jeng, vocab)
    _submit(teng, vocab)
    assert _schedule_view(teng.telemetry.snapshot()) == _schedule_view(jeng.telemetry.snapshot())
    t = 0.0
    while jeng.sched.pending or teng.sched.pending:
        jeng.step(now=t)
        teng.step(now=t)
        t += 0.01
        assert _schedule_view(teng.telemetry.snapshot()) == \
            _schedule_view(jeng.telemetry.snapshot()), jeng.steps
    assert teng.compile_counts() == jeng.compile_counts() == {
        "decode_all": 1, "prefill_all": 1, "prefill_chunk": 0, "verify_all": 0}
    jsnap, tsnap = jeng.telemetry.snapshot(t), teng.telemetry.snapshot(t)
    for name in ("ttft_s", "tpot_s", "queue_wait_s", "request_latency_s",
                 "tokens_per_decode_call"):
        assert tsnap["histograms"][name] == jsnap["histograms"][name], name
    jtr, ttr = list(jeng.telemetry.tracer.completed), list(teng.telemetry.tracer.completed)
    assert [(x.rid, x.events, x.token_times) for x in ttr] == \
        [(x.rid, x.events, x.token_times) for x in jtr]
    assert [x.derived() for x in ttr] == [x.derived() for x in jtr]
    assert tsnap["meta"] == {**jsnap["meta"], "arch": tsnap["meta"]["arch"]}
    assert tsnap["counters"]["decode_tokens"] == tsnap["counters"]["tokens_generated"] - 3


def test_snapshot_carries_full_catalog(pair):
    _, _, tm, tp = pair
    assert {k: v[0] for k, v in CATALOG.items()} == {k: v[0] for k, v in JCATALOG.items()}
    snap = Engine(tm, tp, EngineConfig(**ECFG)).telemetry.snapshot()
    for name, (kind, _) in CATALOG.items():
        assert name in snap[SECTION[kind]], f"{name} missing from snapshot"
    for sec in SECTION.values():
        assert set(snap[sec]) <= set(CATALOG)
    assert validate_snapshot(snap) == jvalidate_snapshot(snap) == []


def test_telemetry_on_is_bit_identical_to_off(pair, tmp_path):
    _, _, tm, tp = pair
    full = TelemetryConfig(metrics_path=str(tmp_path / "m.jsonl"),
                           trace_path=str(tmp_path / "t.jsonl"),
                           prometheus_path=str(tmp_path / "p.prom"), emit_every_ticks=2,
                           quant_stride=1, profile_trace_path=str(tmp_path / "trace.json"))
    runs = {}
    for name, tel in (("off", None), ("on", full)):
        eng = Engine(tm, tp, EngineConfig(**ECFG, kv_dtype="mxfp4", telemetry=tel))
        reqs = _submit(eng, tm.cfg.vocab_size)
        t = _drive(eng)
        runs[name] = (eng, [r.tokens for r in reqs], t)
    (off, off_tokens, _), (on, on_tokens, t) = runs["off"], runs["on"]
    assert on_tokens == off_tokens
    for k, v in off.cache.pool.items():
        assert torch.equal(on.cache.pool[k], v), k
    assert on.compile_counts() == off.compile_counts()
    snap = on.telemetry.finalize(t)
    assert snap["counters"]["quant_health_samples"] > 0
    assert snap["binned"]["kv_scale_hist_k"]["nonzero_bins"] >= 1
    assert 0.0 < snap["gauges"]["kv_clip_fraction_k"] < 1.0
    assert validate_metrics_file(str(tmp_path / "m.jsonl")) >= 2
    assert validate_trace_file(str(tmp_path / "trace.json"))["traceEvents"]
    assert "# TYPE tick_s histogram" in (tmp_path / "p.prom").read_text()
    assert len((tmp_path / "t.jsonl").read_text().splitlines()) == 3


@pytest.mark.parametrize("arch,over,kinds", [
    ("zamba2-7b", dict(num_heads=2, num_kv_heads=2, head_dim=112), ("kv", "state")),
    ("whisper-tiny", {}, ("kv", "cross")),
])
def test_state_pool_engine_reports_health(arch, over, kinds):
    import dataclasses

    cfg = dataclasses.replace(get_reduced_config(arch), **over)
    model = build_model(cfg)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    eng = Engine(model, params, EngineConfig(n_slots=2, max_len=32, page_size=8,
                                             prefill_chunk=8,
                                             telemetry=TelemetryConfig(quant_stride=1)))
    rng = np.random.default_rng(1)
    extra = make_extra(cfg, 0, "cpu")
    for n in (6, 11):
        eng.submit(rng.integers(1, cfg.vocab_size, n).astype(np.int32), 3, extra=extra)
    _drive(eng)
    g = eng.telemetry.snapshot()["gauges"]
    assert eng.telemetry.registry.counter("quant_health_samples").value > 0
    assert g["kv_clip_fraction_k"] > 0 and g["kv_zero_fraction_v"] > 0
    if "state" in kinds:
        assert 0 < g["state_clip_fraction"] < 1 and 0 < g["state_zero_fraction"] < 1
        assert g["cross_clip_fraction_k"] == 0.0
    else:
        assert g["cross_clip_fraction_k"] > 0 and g["cross_zero_fraction_v"] > 0
        assert g["state_clip_fraction"] == 0.0
        assert eng.telemetry.registry.counter("cross_encode_calls").value == 2
    assert g["pool_pages_total"] > 0 and g["pool_occupancy_peak"] > 0
    assert eng.compile_counts()["decode_all"] == 1
