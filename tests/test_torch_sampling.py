"""PyTorch port vs the JAX reference: sampled decoding.

* Keys, random bits and uniforms are jax 0.9.0's bit for bit
  (``core/threefry.py``: ``PRNGKey``, ``fold_in``, ``bits``,
  ``uniform(minval=tiny)``).
* The Gumbel noise −log(−log(u)) takes PyTorch's f32 log where the
  reference takes XLA:CPU's.  XLA:CPU's log is one ulp off the correctly
  rounded value for about 14% of these inputs, PyTorch's for under 0.1%, so
  the inner log differs by at most one ulp and the noise by at most 2e-6
  (measured below: the bound asserted).
* ``filter_logits`` equals the reference's bit for bit on the test rows of
  top-k (ties included) and of top-p up to 0.99.  With top-p near 1 the
  cutoff can differ, by tail tokens within f32 rounding of the edge: on 9 of
  54 rows at top_p >= 0.999 here (the sums add in another order than XLA's).
* ``sample_row`` draws the reference's token on every draw of a sweep of
  4 distributions × 8 seeds × 2 rows × 4 token indices × 3 logit rows.
* The engine's sampling: temperature 0 is greedy, top-k 1 is argmax, a
  sampled engine request equals the port's sampled ``greedy_generate`` with
  the same ``SamplingParams``, and the port's greedy ``greedy_generate``
  equals the argmax of its own teacher-forced forward under ``bf16``
  (ROADMAP C1: the reference's ``greedy_generate`` is no token oracle).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.serve import sampling as JS
from repro_torch.configs import get_reduced_config
from repro_torch.convert import init_params
from repro_torch.core import threefry
from repro_torch.launch.serve_engine import kernel_config
from repro_torch.models import build_model
from repro_torch.serve import Engine, EngineConfig, SamplingParams
from repro_torch.serve import sampling as TS
from repro_torch.train.serve import greedy_generate

pytestmark = pytest.mark.spec


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run many small ops, which several
    threads a worker only slow down when the suite runs on several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _jsp(sp: SamplingParams) -> JS.SamplingParams:
    return JS.SamplingParams(**dataclasses.asdict(sp))


@pytest.mark.parametrize("seed", [0, 1, 11, 2**31 + 5, 2**32 - 1])
def test_threefry_keys_bits_and_uniforms_match_jax(seed):
    for row, t in ((0, 0), (1, 5), (3, 1000)):
        jkey = JS.row_key(jnp.uint32(seed), row, t)
        key = TS.row_key(seed, row, t)
        assert tuple(int(x) for x in np.asarray(jkey)) == key
        n = 50_000
        jb = np.asarray(jax.random.bits(jkey, (n,)))
        assert np.array_equal(jb.astype(np.int64), threefry.random_bits(key, n, "cpu").numpy())
        ju = np.asarray(jax.random.uniform(jkey, (n,), minval=jnp.finfo(jnp.float32).tiny))
        tu = threefry.uniform_tiny(key, n, "cpu").numpy()
        assert np.array_equal(ju.view(np.int32), tu.view(np.int32))
        # the noise: one ulp at most in the inner log, 2e-6 at most after
        # the outer one (where the inner log is tiny its ulp is amplified)
        inner_j = np.asarray(-jnp.log(jnp.asarray(tu)))
        inner_t = (-torch.log(torch.from_numpy(tu))).numpy()
        ulps = np.abs(inner_j.view(np.int32).astype(np.int64) - inner_t.view(np.int32))
        assert ulps.max() <= 1
        jg = np.asarray(jax.random.gumbel(jkey, (n,)))
        tg = threefry.gumbel(key, n, "cpu").numpy()
        assert np.abs(jg - tg).max() <= 2e-6
    with pytest.raises(ValueError):
        threefry.prng_key(-1)


def _rows(rng):
    """Logit rows: narrow, wide and with a 20-way tie at the maximum."""
    out = []
    for V, scale in ((512, 0.5), (1000, 2.0), (4096, 8.0)):
        out.append((rng.standard_normal(V) * scale).astype(np.float32))
    tied = out[0].copy()
    tied[rng.integers(0, 512, 20)] = tied.max()
    out.append(tied)
    return out


FILTERS = [SamplingParams(temperature=0.8, top_k=50, top_p=0.95),
           SamplingParams(temperature=1.3, top_p=0.5),
           SamplingParams(temperature=0.7, top_k=1),
           SamplingParams(temperature=1.0, top_k=20),
           SamplingParams(temperature=1.0, top_p=1e-6),  # only the argmax (and its ties)
           SamplingParams(temperature=0.5, top_p=0.99),
           SamplingParams(temperature=2.0, top_k=5000)]  # k >= V: disabled


def test_filter_logits_matches_reference():
    rows = _rows(np.random.default_rng(0))
    for sp in FILTERS:
        for l in rows:
            want = np.asarray(JS.filter_logits(jnp.asarray(l), _jsp(sp)))
            got = TS.filter_logits(torch.from_numpy(l), sp).numpy()
            assert np.array_equal(want.view(np.int32), got.view(np.int32)), sp
    # top-k keeps ties with the k-th value; top-p keeps the argmax
    tied = rows[3]
    kept = TS.filter_logits(torch.from_numpy(tied), FILTERS[2]).numpy() > -1e29
    assert kept.sum() == (tied == tied.max()).sum() >= 2
    kept = TS.filter_logits(torch.from_numpy(rows[1]), FILTERS[4]).numpy() > -1e29
    assert kept.sum() == 1 and kept[rows[1].argmax()]


def test_top_p_cutoff_differs_only_within_rounding_of_top_p():
    """Top-p near 1: the softmax's sum and the cumulative sum add in another
    order than XLA's, so a tail token whose exclusive cumulative probability
    lies within a few f32 ulps of ``top_p`` may be kept by one and dropped by
    the other.  Over these 3 rows x 3 temperatures x 6 values of top_p the
    kept set differed on 9 of 54 on the CPU of this repo's test machine, all
    at top_p >= 0.999, every differing token within 1e-6 of the edge."""
    rows = _rows(np.random.default_rng(0))[:3]
    same = 0
    for l in rows:
        for temp in (0.5, 1.0, 2.0):
            for top_p in (0.9, 0.99, 0.999, 0.9999, 0.99999, 0.999999):
                sp = SamplingParams(temperature=temp, top_p=top_p)
                want = np.asarray(JS.filter_logits(jnp.asarray(l), _jsp(sp))) > -1e29
                got = TS.filter_logits(torch.from_numpy(l), sp).numpy() > -1e29
                if np.array_equal(want, got):
                    same += 1
                    continue
                assert top_p >= 0.999
                x = l.astype(np.float64) / np.float32(temp)
                p = np.exp(x - x.max())
                p /= p.sum()
                excl = np.sort(p)[::-1].cumsum() - np.sort(p)[::-1]
                edge = excl[np.searchsorted(-np.sort(x)[::-1], -x[want != got])]
                assert np.abs(edge - top_p).max() < 1e-6, (temp, top_p)
    assert same >= 0.8 * 54


def test_sample_row_matches_reference_sweep():
    rows = _rows(np.random.default_rng(1))[:3]
    tot = 0
    for sp in (FILTERS[0], FILTERS[1], FILTERS[3], SamplingParams(temperature=1.0)):
        jsp = _jsp(sp)
        jfn = jax.jit(lambda l, s, r, t, jsp=jsp: JS.sample_row(l, jsp, r, t, seed=s))
        for seed in range(8):
            for l in rows:
                for row in (0, 1):
                    for t in (0, 1, 7, 300):
                        want = int(jfn(jnp.asarray(l), jnp.uint32(seed), jnp.int32(row),
                                       jnp.int32(t)))
                        got = TS.sample_row(torch.from_numpy(l),
                                            dataclasses.replace(sp, seed=seed), row, t)
                        assert got == want, (sp, seed, row, t)
                        tot += 1
    assert tot == 4 * 8 * 3 * 2 * 4


def test_sampling_params_validation():
    with pytest.raises(ValueError):
        SamplingParams(temperature=-1.0)
    with pytest.raises(ValueError):
        SamplingParams(top_p=0.0)
    with pytest.raises(ValueError):
        SamplingParams(top_k=-1)
    assert SamplingParams().greedy and TS.GREEDY.greedy
    assert not SamplingParams(temperature=0.5).greedy
    assert TS.get_sampler(SamplingParams(temperature=0.5)) is TS.get_sampler(
        SamplingParams(temperature=0.5))


@pytest.fixture(scope="module")
def qwen_setup():
    cfg = kernel_config(get_reduced_config("qwen3-1.7b"))
    return cfg, build_model(cfg), init_params(cfg, torch.Generator().manual_seed(0), "cpu")


def _prompts(cfg, lens=(7, 12, 5), seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, cfg.vocab_size, n).astype(np.int32) for n in lens]


def _run(model, params, prompts, max_new=6, *, sampling=None, method="quartet"):
    eng = Engine(model, params, EngineConfig(n_slots=3, max_len=32, page_size=8,
                                             kv_dtype="dense", prefill_chunk=8, method=method))
    handles = [eng.submit(p, max_new, sampling=sampling) for p in prompts]
    eng.drain()
    return handles


def test_temperature_zero_is_greedy(qwen_setup):
    cfg, model, params = qwen_setup
    prompts = _prompts(cfg, lens=(7, 10))
    base = _run(model, params, prompts)
    t0 = _run(model, params, prompts, sampling=SamplingParams())
    assert [h.tokens for h in t0] == [h.tokens for h in base]


def test_top_k_one_is_argmax(qwen_setup):
    cfg, model, params = qwen_setup
    prompts = _prompts(cfg, lens=(9,))
    base = _run(model, params, prompts)
    hs = _run(model, params, prompts, sampling=SamplingParams(temperature=1.3, top_k=1, seed=3))
    assert hs[0].tokens == base[0].tokens


def test_greedy_generate_matches_teacher_forced_argmax(qwen_setup):
    cfg, model, params = qwen_setup
    prompts = _prompts(cfg, lens=(7, 7))
    prompt = torch.from_numpy(np.stack(prompts))
    out = greedy_generate(model, params, prompt, max_new=6, max_len=16, method="bf16")
    assert out.shape == (2, 6) and out.dtype == torch.int32
    seq = torch.cat([prompt, out[:, :-1]], dim=1)
    tf, _ = model.forward(params, seq, 0, method="bf16")
    assert torch.equal(out.long(), tf[:, 6:].argmax(-1))
    assert torch.equal(greedy_generate(model, params, prompt, 1, 16, method="bf16"), out[:, :1])
    with pytest.raises(ValueError):
        greedy_generate(model, params, prompt, 0, 16)


def test_sampled_engine_matches_greedy_generate(qwen_setup):
    """Engine requests and a one-row sampled ``greedy_generate`` share their
    per-token keys → equal streams for equal SamplingParams."""
    cfg, model, params = qwen_setup
    prompts = _prompts(cfg, lens=(7, 12))
    sp = SamplingParams(temperature=0.8, top_k=20, top_p=0.9, seed=11)
    hs = _run(model, params, prompts, sampling=sp)
    for p, h in zip(prompts, hs):
        ref = greedy_generate(model, params, torch.from_numpy(p)[None], max_new=6,
                              max_len=int(p.size) + 6, sampling=sp)
        assert h.tokens == ref[0].tolist()
    # same seed → reproducible; another seed → another stream
    assert [h.tokens for h in _run(model, params, prompts, sampling=sp)] == [h.tokens for h in hs]
    other = _run(model, params, prompts, sampling=dataclasses.replace(sp, seed=12))
    assert [h.tokens for h in other] != [h.tokens for h in hs]
