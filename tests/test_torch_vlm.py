"""The VLM family (llama-3.2-vision-11b reduced: 4 dense layers in 2
super-blocks, each behind a gated cross block, d 128, GQA 4/2, 64 image
tokens): the port against the reference on the CPU.

A cross block's two residuals are gated by tanh of f32 scalars that start
at zero, which would take the whole cross path out of the logits: every
test here sets them (the same values on both sides, ``GATES``), and one
shows the logits then move.  One reference init crosses over leaf by leaf
(``params_from_jax``: ``layers``, ``cross_layers`` with the gates, an
untied head).  The cross-KV encode, the teacher-forced forward (under
QuEST and the plain bf16 products) and the serving steps agree with the
reference's within 2e-5 of max |ref| (f32).  The steps reproduce the
reference's asymmetry (ROADMAP C11): a prefill with ``image_embeds``
recomputes the cross K/V and does not rotate the cross attention's
queries, a decode without them reads the cached cross-KV and does; so the
decodes are held against the reference's decode steps, not against the
teacher-forced forward.  Inputs are numpy draws from a seed.  Under
QuEST a norm's output one ulp away from the reference's (its fixed
summation order) flips a code that sits on a rounding edge, which moves
the logits by far more than 2e-5: the init key here (0) puts no code on
an edge for these inputs (key 4 does, in layer 2), and the bf16 products
check the wiring whatever the key.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import get_reduced_config as jget_reduced
from repro.models import build_model as jbuild
from repro.models import vlm as JV
from repro.train import serve as JSV
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.convert import init_params, params_from_jax
from repro_torch.models import build_model
from repro_torch.models import vlm as V
from repro_torch.models.registry import cache_leaves
from repro_torch.train import serve as SV

ARCH = "llama-3.2-vision-11b"
GATES = (np.array([0.5, -0.7], np.float32), np.array([-0.3, 0.9], np.float32))
RNG = np.random.default_rng(6)
TOKENS = RNG.integers(0, 512, (2, 12)).astype(np.int32)
IMAGE = RNG.standard_normal((2, 64, 128)).astype(np.float32)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _np(t) -> np.ndarray:
    return np.asarray(t.float().numpy() if isinstance(t, torch.Tensor) else t, np.float32)


def _close(got, want, frac):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0, atol=frac * max(np.abs(want).max(), 1.0))


def _set_gates(jp, tp, gates=GATES):
    jp["cross_layers"]["gate_attn"] = jnp.asarray(gates[0])
    jp["cross_layers"]["gate_mlp"] = jnp.asarray(gates[1])
    tp["cross_layers"]["gate_attn"].copy_(torch.from_numpy(gates[0]))
    tp["cross_layers"]["gate_mlp"].copy_(torch.from_numpy(gates[1]))


@pytest.fixture(scope="module")
def pair():
    jm = jbuild(jget_reduced(ARCH, dtype="float32"))
    jp = jax.jit(jm.init)(jax.random.PRNGKey(0))  # the eager init, compiled
    tcfg = get_reduced_config(ARCH, dtype="float32")
    tp = params_from_jax(jax.device_get(jp), tcfg, "cpu")
    _set_gates(jp, tp)
    return jm, jp, build_model(tcfg), tp


def test_configs_and_n_params():
    """The published widths; ``n_params`` is the reference's formula (the
    cross blocks' attention without their MLPs)."""
    cfg, jcfg = get_config(ARCH), jget(ARCH)
    for f in ("num_layers", "d_model", "num_heads", "num_kv_heads", "head_dim", "d_ff",
              "vocab_size", "cross_attn_every", "num_image_tokens", "rope_theta",
              "tie_embeddings"):
        assert getattr(cfg, f) == getattr(jcfg, f), f
    assert cfg.n_params() == jcfg.n_params() == 9_059_696_640
    assert cfg.n_params(non_embedding=False) == jcfg.n_params(non_embedding=False) == \
        10_110_369_792
    assert get_reduced_config(ARCH).n_params() == jget_reduced(ARCH).n_params()


def test_init_tree_matches_reference(pair):
    """The port's own init: the reference's paths, shapes and dtypes (the
    gates f32 scalars stacked [n_super], zero)."""
    jm, jp, tm, _ = pair
    tp = init_params(tm.cfg, torch.Generator().manual_seed(0), "cpu")

    def flat(tree, path=""):
        if isinstance(tree, dict):
            return {k: v for n, t in tree.items() for k, v in flat(t, f"{path}.{n}").items()}
        dt = (str(tree.dtype).split(".")[-1] if isinstance(tree, torch.Tensor)
              else str(np.asarray(tree).dtype))
        return {path: (tuple(np.shape(tree)), dt)}

    assert flat(tp) == flat(jax.device_get(jp))
    assert not tp["cross_layers"]["gate_attn"].any() and not tp["cross_layers"]["gate_mlp"].any()


def _forward_ref(jm, jp, method):
    return np.asarray(jax.jit(lambda p, t, i: jm.forward(p, t, jnp.uint32(11), method=method,
                                                         extra={"image_embeds": i})[0])(
        jp, jnp.asarray(TOKENS), jnp.asarray(IMAGE)))


def _forward_port(tm, tp, method):
    with torch.no_grad():
        return tm.forward(tp, torch.from_numpy(TOKENS), 11, method=method,
                          extra={"image_embeds": torch.from_numpy(IMAGE)})[0]


@pytest.mark.parametrize("method", ["bf16", "quartet"])
def test_teacher_forced_logits_match_reference(pair, method):
    jm, jp, tm, tp = pair
    _close(_forward_port(tm, tp, method), _forward_ref(jm, jp, method), 2e-5)


def test_gates_move_the_logits(pair):
    """At zero gates the image does not reach the logits (the same logits
    for two images); with the gates set it does, on both sides."""
    jm, jp, tm, tp = pair
    gated = _forward_port(tm, tp, "bf16")
    zero = {**tp, "cross_layers": {**tp["cross_layers"],
                                   "gate_attn": torch.zeros(2), "gate_mlp": torch.zeros(2)}}
    jzero = {**jp, "cross_layers": {**jp["cross_layers"],
                                    "gate_attn": jnp.zeros(2), "gate_mlp": jnp.zeros(2)}}
    ungated = _forward_port(tm, zero, "bf16")
    assert float((gated - ungated).abs().max()) > 0.1
    _close(ungated, _forward_ref(jm, jzero, "bf16"), 2e-5)
    with torch.no_grad():
        other = tm.forward(zero, torch.from_numpy(TOKENS), 11, method="bf16",
                           extra={"image_embeds": torch.from_numpy(IMAGE[::-1].copy())})[0]
    assert torch.equal(other, ungated)


def test_encode_cross_kv_matches_reference(pair):
    jm, jp, tm, tp = pair
    jk, jv = jax.jit(lambda p, i: JV.encode_cross_kv(p, i, jm.cfg, jnp.uint32(2**32 - 1),
                                                     "quartet"))(jp, jnp.asarray(IMAGE))
    with torch.no_grad():
        k, v = V.encode_cross_kv(tp, torch.from_numpy(IMAGE), tm.cfg, 2**32 - 1, "quartet")
    assert k.shape == (2, 2, 64, 2, 32)
    _close(k, jk, 2e-5)
    _close(v, jv, 2e-5)


def test_cache_spec_matches_reference(pair):
    jm, _, tm, _ = pair
    want, got = jm.cache_spec(3, 40), tm.cache_spec(3, 40)
    assert got["cross"][0][0] == (2, 3, 64, 2, 32)
    assert [(tuple(s), str(d).split(".")[-1]) for s, d in cache_leaves(got)] == \
        [(tuple(w.shape), str(w.dtype)) for w in jax.tree.leaves(want)]


def test_cached_steps_match_reference(pair):
    """A prefill chunk of 8 with the image (the cross K/V recomputed and
    written, unrotated queries), then 4 decodes without it (the cached
    cross-KV read, the cross attention's queries rotated: C11), each
    step's logits within 2e-5 of the reference's, the caches within 1e-5.
    The prefill's logits equal the teacher-forced forward's; the decodes'
    do not (the rotated queries)."""
    jm, jp, tm, tp = pair
    chunk = jax.jit(JSV.make_chunk_prefill_step(jm, method="bf16"))
    dec = jax.jit(JSV.make_decode_step(jm, method="bf16"))
    jc = JSV.init_cache(jm, 2, 32)
    w, jc, jpos = chunk(jp, jnp.asarray(TOKENS[:, :8]), jnp.zeros((2,), jnp.int32), jc,
                        {"image_embeds": jnp.asarray(IMAGE)})
    want = [w]
    for t in range(8, 12):
        w, jc, jpos = dec(jp, jnp.asarray(TOKENS[:, t:t + 1]), jpos, jc)
        want.append(w)
    tchunk = SV.make_chunk_prefill_step(tm, method="bf16")
    tdec = SV.make_decode_step(tm, method="bf16")
    tc = SV.init_cache(tm, 2, 32, "cpu")
    g, tc, tpos = tchunk(tp, torch.from_numpy(TOKENS[:, :8]), torch.zeros((2,), dtype=torch.int32),
                         tc, {"image_embeds": torch.from_numpy(IMAGE)})
    got = [g]
    for t in range(8, 12):
        g, tc, tpos = tdec(tp, torch.from_numpy(TOKENS[:, t:t + 1]), tpos, tc)
        got.append(g)
    for g, w in zip(got, want):
        _close(g, w, 2e-5)
    for g, w in zip(cache_leaves(tc), jax.tree.leaves(jc)):
        _close(g, w, 1e-5)
    whole = _forward_port(tm, tp, "bf16")
    _close(got[0], whole[:, 7], 1e-5)
    assert float((got[1] - whole[:, 8]).abs().max()) > 1e-3  # C11: the decode ropes q


def test_greedy_generate_with_the_image_matches_teacher_forced(pair):
    """``greedy_generate`` hands ``extra`` to every step, as the
    reference's does: its decodes recompute the cross K/V from the image,
    so each token is the argmax of the teacher-forced forward."""
    _, _, tm, tp = pair
    extra = {"image_embeds": torch.from_numpy(IMAGE[:1])}
    prompt = torch.from_numpy(TOKENS[:1, :6])
    out = SV.greedy_generate(tm, tp, prompt, 5, 16, extra=extra, method="bf16")
    seq = torch.cat([prompt, out], 1)
    with torch.no_grad():
        logits, _ = tm.forward(tp, seq[:, :-1], 0, method="bf16", extra=extra)
    assert torch.equal(out[0], torch.argmax(logits[0, 5:], -1).to(torch.int32))
