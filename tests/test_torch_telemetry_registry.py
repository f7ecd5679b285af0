"""PyTorch port vs the JAX reference: the telemetry's pure-Python modules.

The port copies the reference's registry, tracer, sinks, schema and
regression gate.  Equal inputs go through both packages and must give equal
outputs exactly: snapshots and Prometheus text (percentiles, the EWMA
update and the ``%g`` formatting included), merged registries, the console
summary, the tracer's derived TTFT/TPOT and its trace lines, the
regression gate's deltas, tables and CLI exit codes on documents this test
builds, and each package's snapshot, benchmark document and metrics file
accepted (or rejected, with equal errors) by the other package's
validators.
"""

import dataclasses
import io
import json

import numpy as np
import pytest

from repro.serve.telemetry import registry as JR
from repro.serve.telemetry import regression as JG
from repro.serve.telemetry import schema as JS
from repro.serve.telemetry import sinks as JK
from repro.serve.telemetry import tracing as JT
from repro_torch.serve.telemetry import registry as TR
from repro_torch.serve.telemetry import regression as TG
from repro_torch.serve.telemetry import schema as TS
from repro_torch.serve.telemetry import sinks as TK
from repro_torch.serve.telemetry import tracing as TT


def _fill(R, seed: int, max_samples: int = 64):
    """One registry fed a seeded stream of every metric kind's updates
    (past the histogram reservoir, through non-advancing EWMA marks)."""
    rng = np.random.default_rng(seed)
    reg = R.MetricsRegistry(hist_max_samples=max_samples)
    reg.meta.update(arch="a", n_slots=2, spec_k=None)
    reg.counter("engine_ticks", "ticks").inc(int(rng.integers(1, 50)))
    reg.counter("tokens_generated").inc(7)
    g = reg.gauge("pool_occupancy_peak", "peak")
    for v in rng.random(9):
        g.set_max(float(v))
    w = reg.gauge("pool_pages_free_watermark")
    w.set(100.0)
    for v in rng.integers(3, 90, 9):
        w.set_min(float(v))
    reg.gauge("kv_clip_fraction_k").set(float(np.float32(rng.random())))
    h = reg.histogram("tick_s", "tick")
    for v in rng.exponential(0.02, 150):
        h.observe(float(v))
    reg.histogram("ttft_s")  # empty
    reg.histogram("big").observe(120.0)
    b = reg.binned("kv_scale_hist_k", 256, "scales")
    b.set_counts(rng.integers(0, 5, 256).tolist())
    b.merge_counts(rng.integers(0, 3, 256).tolist())
    r = reg.rate("tokens_per_sec_ewma", halflife_s=0.5)
    t = 0.0
    for n in rng.integers(0, 9, 20):
        t += float(rng.choice([0.0, 0.013, 0.27]))
        r.mark(int(n), t)
    return reg


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_registry_snapshot_and_prometheus_equal(seed):
    j, t = _fill(JR, seed), _fill(TR, seed)
    assert t.snapshot(3.5) == j.snapshot(3.5)
    assert t.prometheus_text() == j.prometheus_text()
    for q in (0.0, 0.37, 0.5, 0.95, 0.99, 1.0):
        assert t.histogram("tick_s").percentile(q) == j.histogram("tick_s").percentile(q)
    # reset keeps the schema in both
    j.reset()
    t.reset()
    assert t.snapshot() == j.snapshot()
    assert t.prometheus_text() == j.prometheus_text()


def test_merge_registries_equal():
    js = [_fill(JR, s, max_samples=40) for s in range(3)]
    ts = [_fill(TR, s, max_samples=40) for s in range(3)]
    ts[0].counter("only_here").inc(3)
    js[0].counter("only_here").inc(3)
    jm, tm = JR.merge_registries(js), TR.merge_registries(ts)
    assert tm.snapshot(1.0) == jm.snapshot(1.0)
    assert tm.prometheus_text() == jm.prometheus_text()
    jh = JR.merge_histograms([r.histogram("tick_s") for r in js])
    th = TR.merge_histograms([r.histogram("tick_s") for r in ts])
    assert th.summary() == jh.summary()


def test_render_summary_and_sinks_equal(tmp_path):
    j, t = _fill(JR, 4), _fill(TR, 4)
    assert TK.render_summary(t.snapshot(2.0)) == JK.render_summary(j.snapshot(2.0))
    # each package's sinks write equal files
    for K, reg, tag in ((JK, j, "j"), (TK, t, "t")):
        jl = K.JsonlSink(str(tmp_path / f"{tag}.jsonl"))
        prom = K.PrometheusTextSink(str(tmp_path / f"{tag}.prom"))
        out = io.StringIO()
        con = K.ConsoleSink(every=2, stream=out)
        for i in range(3):
            snap = reg.snapshot(float(i))
            for s in (jl, prom, con):
                s.emit(snap, reg)
        jl.close()
        (tmp_path / f"{tag}.con").write_text(out.getvalue())
    for ext in ("jsonl", "prom", "con"):
        assert (tmp_path / f"t.{ext}").read_text() == (tmp_path / f"j.{ext}").read_text()
    assert TS.validate_metrics_file(str(tmp_path / "t.jsonl")) == 3
    assert JS.validate_metrics_file(str(tmp_path / "t.jsonl")) == 3


def _script(T, reg, path):
    """A tracer fed one seeded timeline per request (one single-token
    request, one never retired)."""
    rng = np.random.default_rng(5)
    tr = T.Tracer(reg, path=path, keep=3)
    for rid in range(5):
        t = float(rng.random())
        tr.event(rid, "submit", t)
        t += float(rng.random() * 0.1)
        tr.event(rid, "admit", t)
        t += float(rng.random() * 0.2)
        tr.event(rid, "first_token", t)
        tr.tokens(rid, t, 1)
        for _ in range(0 if rid == 1 else int(rng.integers(1, 6))):
            t += float(rng.random() * 0.05)
            tr.tokens(rid, t, int(rng.integers(0, 4)))
        if rid != 4:
            tr.event(rid, "retire", t)
    tr.close()
    return tr


def test_tracer_derived_equal(tmp_path):
    jreg, treg = JR.MetricsRegistry(), TR.MetricsRegistry()
    j = _script(JT, jreg, str(tmp_path / "j.jsonl"))
    t = _script(TT, treg, str(tmp_path / "t.jsonl"))
    assert [tr.derived() for tr in t.completed] == [tr.derived() for tr in j.completed]
    assert [tr.spans() for tr in t.completed] == [tr.spans() for tr in j.completed]
    assert list(t.active) == list(j.active) == [4]
    assert (tmp_path / "t.jsonl").read_text() == (tmp_path / "j.jsonl").read_text()
    assert treg.snapshot() == jreg.snapshot()
    one = next(tr for tr in t.completed if tr.rid == 1)
    assert one.derived()["tpot_s"] is None


def _bench_doc(spec) -> dict:
    """A document satisfying a benchmark spec: numbers 1.5, strings "x",
    nullable sections present, map sections with one block."""
    out = {}
    for key, want in spec.items():
        if isinstance(want, JS._MapOf):
            out[key] = {"fam": _bench_doc(want.spec)}
        elif isinstance(want, JS._Nullable):
            out[key] = _bench_doc(want.spec)
        elif isinstance(want, dict):
            out[key] = _bench_doc(want)
        elif want is str:
            out[key] = "x"
        else:
            out[key] = 1.5
    return out


def test_schema_validators_cross_accept(tmp_path):
    doc = _bench_doc(JS._BENCH_SPEC)
    doc["schema"] = JS.BENCH_SCHEMA
    assert TS.BENCH_SCHEMA == JS.BENCH_SCHEMA and TS.METRICS_SCHEMA == JR.METRICS_SCHEMA
    assert TS.validate_bench(doc) == JS.validate_bench(doc) == []
    broken = json.loads(json.dumps(doc))
    broken["throughput"]["mxfp4_paged_tok_per_s"] = None
    del broken["pool"]
    broken["sharding"] = "no"
    broken["families"]["fam"]["token_parity"] = True
    errs = JS.validate_bench(broken)
    assert errs and TS.validate_bench(broken) == errs
    path = tmp_path / "bench.json"
    path.write_text(json.dumps(doc))
    assert TS.validate_bench_file(str(path)) == JS.validate_bench_file(str(path))
    # each package's snapshot passes the other's validator
    for snap in (_fill(JR, 0).snapshot(1.0), _fill(TR, 0).snapshot(1.0)):
        assert TS.validate_snapshot(snap) == JS.validate_snapshot(snap) == []
        bad = dict(snap, counters={"c": -1}, schema=snap["schema"])
        assert TS.validate_snapshot(bad) == JS.validate_snapshot(bad) != []
    assert TS.validate_snapshot({"schema": "nope"}) == JS.validate_snapshot({"schema": "nope"})


def _gate_docs():
    base = _bench_doc(JS._BENCH_SPEC)
    base["schema"] = JS.BENCH_SCHEMA
    base["spec"]["acceptance_rate"] = None
    fresh = json.loads(json.dumps(base))
    fresh["throughput"]["mxfp4_paged_tok_per_s"] = 1.0  # soft: -33%
    fresh["kv"]["cache_ratio"] = 1.49  # hard, inside 1%
    fresh["latency"]["ttft_p50_s"] = 3.0  # soft: +100%
    fresh["pool"]["occupancy_peak"] = 9.0  # info
    fresh["spec"]["acceptance_rate"] = 0.5  # new
    failing = json.loads(json.dumps(fresh))
    failing["kv"]["cache_bytes_mxfp4"] = 2.0  # hard exact
    failing["families"]["fam"]["token_parity"] = None  # hard, gone
    return base, fresh, failing


def test_regression_gate_equal(tmp_path, capsys):
    base, fresh, failing = _gate_docs()
    for f in (fresh, failing):
        assert ([dataclasses.asdict(d) for d in TG.compare(base, f)]
                == [dataclasses.asdict(d) for d in JG.compare(base, f)])
        for strict in (False, True):
            tok, tdeltas, trep = TG.gate(base, f, strict=strict)
            jok, jdeltas, jrep = JG.gate(base, f, strict=strict)
            assert (tok, trep) == (jok, jrep)
        assert TG.render_table(TG.compare(base, f), show_ok=True) == \
            JG.render_table(JG.compare(base, f), show_ok=True)
        assert TG.flatten(f) == JG.flatten(f)
    paths = {}
    for name, doc in (("base", base), ("fresh", fresh), ("failing", failing)):
        paths[name] = tmp_path / f"{name}.json"
        paths[name].write_text(json.dumps(doc))
    (tmp_path / "bad.json").write_text("{not json")
    cases = [[str(paths["fresh"]), "--baseline", str(paths["base"])],
             [str(paths["fresh"]), "--baseline", str(paths["base"]), "--strict"],
             [str(paths["failing"]), "--baseline", str(paths["base"])],
             [str(tmp_path / "bad.json"), "--baseline", str(paths["base"])]]
    codes = []
    for argv in cases:
        outs = []
        for G in (JG, TG):
            rc = G.main(argv + ["--json", str(tmp_path / "d.json")])
            outs.append((rc, capsys.readouterr().out))
        assert outs[0] == outs[1]
        codes.append(outs[1][0])
    assert codes == [0, 1, 1, 2]
