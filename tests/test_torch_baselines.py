"""PyTorch port vs the JAX reference: the paper's baseline training methods.

The same seeded numpy inputs go through ``repro.core.baselines`` (jitted) and
``repro_torch.core.baselines`` on the CPU.

Tolerances:
* The quantizers (LUQ's log grid, RTN and stochastic; Jetfire's 32×32
  tiles; HALO's per-tensor E2M1 RTN and its group; INT4 RTN): bit for bit,
  NaN and ±0 places included, from the same inputs and keys.  LUQ's
  exponents are exact in the port (read from the bits) where the
  reference's f32 ``log2`` misrounds just below 2^k (floor) and near
  √2·2^k (round), ROADMAP C2/C8: every disagreement is asserted to sit at
  such a misround, and the port to equal the float64 evaluation of the
  formula.  LSS's row sampling: the same decisions, the weights 1/p within
  rtol 2e-6 (the row norms sum in another order in the two libraries).
* ``baseline_linear`` y, dx and dW against ``jax.vjp`` of the reference:
  rtol 1e-5, atol 1e-6·max|ref| (f32 GEMMs sum in another order).  The
  port's group-32 Hadamard takes XLA:CPU's order here
  (``xla_cpu_hadamard``), as the Quartet tests do; at groups of 64 and 128
  the port's product already equals XLA's on these shapes.
* dW through an f32 master cast to bf16: the reference's f32 dW within rtol
  1e-5, where bf16 rounding would move nearly every element by up to 2⁻⁹.
* ``moe_ffn`` under a baseline (the reference's vmapped experts): y rtol
  1e-4, atol 1e-5·max|ref|; gradients rtol 1e-4, atol 1e-4·max|ref| per
  leaf, as the Quartet MoE gradient test.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_numerics import xla_cpu_hadamard

from repro.configs import get_reduced_config as jget_reduced
from repro.core import baselines as JB
from repro.core import formats as JF
from repro.models import layers as JL
from repro.models import moe as JM
from repro_torch.configs import get_reduced_config
from repro_torch.convert import _leaf
from repro_torch.core import baselines as TB
from repro_torch.core import formats as TF
from repro_torch.core import threefry
from repro_torch.core.hadamard import hadamard_transform
from repro_torch.core.quartet import QuartetConfig
from repro_torch.models import layers as TL
from repro_torch.models import moe as TM
from repro_torch.tree import tree_leaves, tree_unflatten

METHODS = TB.BASELINE_METHODS
MOE_ARCH = "qwen3-moe-235b-a22b"


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _bits(got, want):
    """Equal bit patterns (so ±0 apart), NaN at the same places."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.int32), want[~nan].view(np.int32))


def _close(got, want, rtol, atol_frac, name=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_frac * np.abs(want).max(),
                               err_msg=name)


def _keys(seed: int):
    """The reference's ``fold_in(PRNGKey(0xB5), seed)`` and the port's batch
    of one key from the same seed."""
    jkey = jax.random.fold_in(jax.random.PRNGKey(0xB5), jnp.uint32(seed))
    return jkey, threefry.fold_in_many(threefry.prng_key(0xB5), torch.tensor([seed]))


def reference_order_hadamard(x, g=32, dim=-1):
    """The port's Hadamard in XLA:CPU's summation order at group 32 (its two
    FMA chains); at 64 and 128 the port's own product is XLA's here."""
    return xla_cpu_hadamard(x, g, dim) if g == 32 else hadamard_transform(x, g, dim)


# ---------------------------------------------------------------------------
# the keys
# ---------------------------------------------------------------------------


def test_threefry_key_batches_equal_vmapped_jax():
    """``fold_in_many``, ``split_many`` and ``uniform_many``: row e equals
    ``jax.random`` under seed e's key (seeds at and above 2^31 included)."""
    seeds = [0, 7, 2**31, 2**32 - 1]
    k0, k1 = threefry.fold_in_many(threefry.prng_key(0xB5), torch.tensor(seeds))
    subs = threefry.split_many((k0, k1), 3)
    u = threefry.uniform_many(subs[2], (5, 7))
    for e, s in enumerate(seeds):
        jk = jax.random.fold_in(jax.random.PRNGKey(0xB5), jnp.uint32(s))
        np.testing.assert_array_equal([int(k0[e]), int(k1[e])], np.asarray(jk))
        jsubs = jax.random.split(jk, 3)
        for i in range(3):
            np.testing.assert_array_equal([int(subs[i][0][e]), int(subs[i][1][e])],
                                          np.asarray(jsubs[i]))
        _bits(u[e].numpy(), jax.random.uniform(jsubs[2], (5, 7)))


# ---------------------------------------------------------------------------
# the quantizers
# ---------------------------------------------------------------------------


def _luq_input():
    """Random values over 12 binades and the log2 edges of the grid: for
    k = -7..-1, the 64 floats just below 2^k, 2^k itself, and ±8 ulps
    around √2·2^k; one element 1.0, so the per-tensor scale is 1 and
    a = |x| exactly; ±0."""
    rng = np.random.default_rng(3)
    edges = []
    for k in range(-7, 0):
        top = np.float32(2.0**k).view(np.int32)
        edges.append((top - np.arange(0, 65, dtype=np.int32)).view(np.float32))
        mid = np.float32(np.sqrt(2.0) * 2.0**k).view(np.int32)
        edges.append((mid + np.arange(-8, 9, dtype=np.int32)).view(np.float32))
    edges = np.concatenate(edges)
    rand = (rng.uniform(-1, 1, 2000) * np.exp2(rng.integers(-12, 0, 2000))).astype(np.float32)
    x = np.concatenate([[1.0, 0.0, -0.0], edges, -edges, rand]).astype(np.float32)
    return x.reshape(1, -1)


@pytest.mark.parametrize("stochastic", [False, True])
def test_luq_quantize_bits_and_log2_edges(stochastic):
    x = _luq_input()
    jkey, tkeys = _keys(11)
    jk, tk = (jkey, tkeys) if stochastic else (None, None)
    want = np.asarray(jax.jit(lambda a, k: JB._luq_quantize(a, k, stochastic))(
        jnp.asarray(x), jk) if stochastic else jax.jit(
        lambda a: JB._luq_quantize(a, None, False))(jnp.asarray(x)))
    got = TB._luq_quantize(torch.from_numpy(x)[None], tk, stochastic)[0].numpy()
    a = np.abs(x).astype(np.float64)
    if stochastic:  # floor(log2(max(a, 2^-6))): the reference's f32 log2 against float64
        ref_e = np.asarray(jnp.floor(jnp.log2(jnp.maximum(jnp.asarray(np.abs(x)), 2.0**-6))))
        exact_e = np.floor(np.log2(np.maximum(a, 2.0**-6)))
    else:  # round(log2(max(a, 2^-7)))
        ref_e = np.asarray(jnp.round(jnp.log2(jnp.maximum(jnp.asarray(np.abs(x)), 2.0**-7))))
        exact_e = np.round(np.log2(np.maximum(a, 2.0**-7)))
        exact = np.sign(x) * np.where(a < 2.0**-7, 0.0, np.exp2(np.clip(exact_e, -6, 0)))
        np.testing.assert_array_equal(got, exact.astype(np.float32))
    misround = ref_e != exact_e
    assert misround.sum() >= 10  # the sweep reaches the reference's misrounds
    differ = got.view(np.int32) != want.view(np.int32)
    assert not np.any(differ & ~misround), np.nonzero(differ & ~misround)
    # where the reference's log2 is right the two agree bit for bit, ±0 included
    _bits(got[~misround], want[~misround])
    assert np.signbit(got[0, 2]) and got[0, 1] == 0 and not np.signbit(got[0, 1])
    # a NaN makes the per-tensor scale NaN: every value NaN on both
    xn = x.copy()
    xn[0, 5] = np.nan
    jn = (jax.jit(lambda a, k: JB._luq_quantize(a, k, True))(jnp.asarray(xn), jkey)
          if stochastic else jax.jit(lambda a: JB._luq_quantize(a, None, False))(
              jnp.asarray(xn)))
    _bits(TB._luq_quantize(torch.from_numpy(xn)[None], tk, stochastic)[0].numpy(), jn)


@pytest.mark.parametrize("fmt", ["mxfp4", "int4"])
def test_block2d_rtn_bits(fmt):
    """32×32 tiles with zero padding on both edges, a NaN tile and ±0."""
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((70, 50)) * np.exp2(rng.integers(-6, 6, (70, 1)))).astype(
        np.float32)
    x[3, 4], x[40, 40], x[41, 41] = np.nan, 0.0, -0.0
    want = jax.jit(lambda a: JB._block2d_rtn(a, JF.get_format(fmt)))(jnp.asarray(x))
    _bits(TB._block2d_rtn(torch.from_numpy(x)[None], TF.get_format(fmt))[0].numpy(), want)


def test_halo_quantize_and_group_bits():
    rng = np.random.default_rng(6)
    x = (rng.standard_normal((64, 96)) * 3).astype(np.float32)
    x[0, :4] = [0.0, -0.0, 6e-9, -6e-9]
    want = jax.jit(lambda a: JB._halo_quantize(a, JF.MXFP4))(jnp.asarray(x))
    _bits(TB._halo_quantize(torch.from_numpy(x)[None], TF.MXFP4)[0].numpy(), want)
    for k in (1, 3, 32, 96, 128, 384, 1280, 3456, 4096):
        assert TB._halo_group(k) == JB._halo_group(k)


def test_int4_rtn_bits_and_lss_sample():
    rng = np.random.default_rng(7)
    x = (rng.standard_normal((64, 96)) * np.exp2(rng.integers(-4, 4, (64, 1)))).astype(
        np.float32)
    x[1, 3], x[2, 0], x[2, 1] = np.nan, 0.0, -0.0
    _bits(TB._int4_rtn(torch.from_numpy(x)).numpy(), jax.jit(JB._int4_rtn)(jnp.asarray(x)))
    g = rng.standard_normal((128, 96)).astype(np.float32) * rng.uniform(0, 2, (128, 1)).astype(
        np.float32)
    other = rng.standard_normal((128, 64)).astype(np.float32)
    jkey, tkeys = _keys(5)
    want = np.asarray(jax.jit(JB._lss_sample)(jnp.asarray(g), jnp.asarray(other), jkey))
    got = TB._lss_sample(torch.from_numpy(g)[None], torch.from_numpy(other)[None], tkeys)[0]
    np.testing.assert_array_equal(got.numpy() > 0, want > 0)
    assert 0 < int((want > 0).sum()) < 128
    np.testing.assert_allclose(got.numpy(), want, rtol=2e-6)


# ---------------------------------------------------------------------------
# the linear layer
# ---------------------------------------------------------------------------


def _linear_case(dtype=np.float32):
    rng = np.random.default_rng(8)
    x = rng.standard_normal((2, 64, 128)).astype(np.float32)
    w = (rng.standard_normal((128, 96)) / 11).astype(np.float32)
    dy = rng.standard_normal((2, 64, 96)).astype(np.float32)
    return x, w, dy


@pytest.mark.parametrize("method", METHODS)
def test_baseline_linear_matches_reference_vjp(method, monkeypatch):
    monkeypatch.setattr(TB, "hadamard_transform", reference_order_hadamard)
    x, w, dy = _linear_case()
    seed = 2**31 + 17

    def ref(xx, ww, g):
        y, vjp = jax.vjp(lambda a, b: JB.baseline_linear(a, b, jnp.uint32(seed), method), xx, ww)
        return (y, *vjp(g))

    jy, jdx, jdw = jax.jit(ref)(jnp.asarray(x), jnp.asarray(w), jnp.asarray(dy))
    xt, wt = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    y = TB.baseline_linear(xt, wt, seed, method)
    dx, dw = torch.autograd.grad(y, [xt, wt], torch.from_numpy(dy))
    assert dw.dtype == torch.float32
    for name, got, want in (("y", y.detach(), jy), ("dx", dx, jdx), ("dW", dw, jdw)):
        assert float(np.abs(np.asarray(want)).max()) > 0
        _close(got.numpy(), want, 1e-5, 1e-6, f"{method} {name}")


@pytest.mark.parametrize("method", METHODS)
def test_dw_reaches_f32_master_unrounded(method, monkeypatch):
    """``dense`` on an f32 master weight with bf16 activations: the weight is
    cast to bf16 inside, and dW reaches the master in f32, as the reference's
    ``jax.grad`` through its f32→bf16 cast delivers it.  A Function over the
    bf16 weight would round dW to bf16, which moves most elements here."""
    monkeypatch.setattr(TB, "hadamard_transform", reference_order_hadamard)
    x, w, dy = _linear_case()
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    r = jnp.asarray(dy).astype(jnp.bfloat16).astype(jnp.float32)
    jcfg = JL.QuartetConfig()

    def jloss(w32):
        y = JL.dense({"w": w32.astype(jnp.bfloat16)}, xb, jnp.uint32(23), jcfg, method)
        return jnp.sum(y.astype(jnp.float32) * r)

    jdw = np.asarray(jax.jit(jax.grad(jloss))(jnp.asarray(w)))
    assert jdw.dtype == np.float32
    wt = torch.from_numpy(w).requires_grad_()
    xt = torch.from_numpy(np.array(xb.astype(jnp.float32))).to(torch.bfloat16)
    y = TL.dense({"w": wt}, xt, 23, QuartetConfig(), method)
    assert y.dtype == torch.bfloat16
    (dw,) = torch.autograd.grad((y.to(torch.float32) * torch.from_numpy(np.array(r))).sum(),
                                [wt])
    assert dw.dtype == torch.float32
    _close(dw.numpy(), jdw, 1e-5, 1e-6, method)
    rounded = dw.to(torch.bfloat16).to(torch.float32)
    assert float((rounded != dw).float().mean()) > 0.9


def test_dense_and_dense_experts_take_every_baseline():
    rng = np.random.default_rng(9)
    x = torch.from_numpy(rng.standard_normal((3, 32, 64)).astype(np.float32))
    w = torch.from_numpy(rng.standard_normal((3, 64, 32)).astype(np.float32))
    seeds = torch.tensor([1, 2, 3])
    for method in METHODS:
        y = TL.dense({"w": w[0]}, x[0], 4, QuartetConfig(), method)
        ye = TL.dense_experts(w, x, seeds, QuartetConfig(), method)
        assert y.shape == (32, 32) and ye.shape == (3, 32, 32)
        assert torch.isfinite(y).all() and torch.isfinite(ye).all()
        # expert e alone is the 2-d linear at seed e's value
        assert torch.equal(ye[1], TB.baseline_linear(x[1], w[1], 2, method))
    with pytest.raises(ValueError, match="unknown baseline method"):
        TL.dense({"w": w[0]}, x[0], 4, QuartetConfig(), "luq")


def test_master_weights_are_the_baseline_linears():
    """The leaves the train step passes uncast under a baseline: every dense
    weight but the MoE router's, and the expert stacks."""
    def paths(tree, p=()):
        if isinstance(tree, dict):
            return [q for k in sorted(tree) for q in paths(tree[k], p + (k,))]
        return [p]

    cfg = get_reduced_config(MOE_ARCH, dtype="float32")
    from repro_torch.convert import init_params

    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    kept = sorted("/".join(p) for p in paths(params) if TL.takes_master_weight(p))
    want = sorted(f"layers/{a}" for a in ("attn/wq/w", "attn/wk/w", "attn/wv/w", "attn/wo/w",
                                          "moe/gate", "moe/up", "moe/down"))
    assert kept == sorted(want + (["lm_head/w"] if "lm_head" in params else []))


# ---------------------------------------------------------------------------
# a MoE layer's experts under a baseline
# ---------------------------------------------------------------------------


def _tree(np_tree):
    if isinstance(np_tree, dict):
        return {k: _tree(v) for k, v in np_tree.items()}
    return _leaf(np_tree, "cpu")


@pytest.mark.parametrize("method", ["jetfire_fp4", "luq_int4"])
def test_moe_ffn_baseline_grads_match_reference(method):
    """``moe_ffn`` forward and backward (reduced qwen3-moe, f32, 64 tokens,
    32 rows an expert) against ``jax.grad`` of the reference's, whose
    experts are a ``jax.vmap`` of ``dense``: per-expert scales and keys."""
    jcfg = jget_reduced(MOE_ARCH, dtype="float32")
    tcfg = get_reduced_config(MOE_ARCH, dtype="float32")
    jp = JM.init_moe_ffn(jax.random.PRNGKey(0), jcfg, jnp.float32)
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 32, jcfg.d_model)).astype(np.float32)
    r = rng.standard_normal(x.shape).astype(np.float32)
    seed = 2**31 + 3

    def jloss(p, xx):
        y, aux = JM.moe_ffn(p, xx, jnp.uint32(seed), jcfg, method=method)
        return jnp.sum(y * r) + 0.3 * aux, (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1),
                                                             has_aux=True))(jp, x)
    tp = _tree(jax.device_get(jp))
    leaves = [t.clone().requires_grad_() for t in tree_leaves(tp)]
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = TM.moe_ffn(tree_unflatten(tp, leaves), xt, seed, tcfg, method=method)
    grads = torch.autograd.grad((y * torch.from_numpy(r)).sum() + 0.3 * aux, [xt, *leaves])
    _close(y.detach().numpy(), jy, 1e-4, 1e-5, "y")
    assert abs(float(aux.detach()) - float(jaux)) <= 1e-6 * abs(float(jaux))
    _close(grads[0].numpy(), jgx, 1e-4, 1e-4, "dx")
    jleaves = jax.tree.leaves(jgp)
    assert len(jleaves) == len(leaves) == 4  # down, gate, router.w, up
    for name, g, jg in zip(("down", "gate", "router", "up"), grads[1:], jleaves):
        assert float(np.abs(np.asarray(jg)).max()) > 0
        _close(g.numpy(), jg, 1e-4, 1e-4, name)


# ---------------------------------------------------------------------------
# the script twins
# ---------------------------------------------------------------------------


def test_script_twins_run_on_the_cpu(capsys, monkeypatch):
    """Table 3, Fig. 2, Table 7, the format ablation and the method
    comparison at tiny budgets: the originals' rows, finite losses (the
    method comparison on three of its methods: Table 3's twin runs all
    seven through the same loop)."""
    from repro_torch.benchmarks import ablation_formats, fig2_gradient_alignment
    from repro_torch.benchmarks import table3_method_comparison, table7_ptq_vs_native
    from repro_torch.examples import method_comparison

    rows = table3_method_comparison.run("cpu", steps_grid=[1])
    assert [r[0] for r in rows] == [f"table3/{m}/steps1" for m in
                                    table3_method_comparison.METHODS] + [
        "table3/quartet_beats_all_4bit_priors", "table3/quartet_near_bf16"]
    assert all(np.isfinite(float(r[2].split("=")[1])) for r in rows[:-2])
    rows = fig2_gradient_alignment.run("cpu", budgets=(1, 2))
    names = [r[0] for r in rows]
    assert names[:4] == ["fig2a/rtn/cosine_by_depth", "fig2b/rtn/magnitude_by_depth",
                         "fig2a/sr/cosine_by_depth", "fig2b/sr/magnitude_by_depth"]
    cos = [float(v) for v in rows[0][2].split()]
    assert len(cos) == fig2_gradient_alignment.DEPTH and all(0.5 < c <= 1.0 for c in cos)
    assert names[-1] == "fig2c/sr_gains_with_budget"
    rows = table7_ptq_vs_native.run("cpu", steps=1)
    assert [r[0] for r in rows] == ["table7/bf16_eval", "table7/ptq_quarot_eval",
                                    "table7/quartet_native_eval", "table7/native_beats_ptq"]
    rows = ablation_formats.run("cpu", steps=1)
    assert rows[3] == ("ablation/mse_ordering_fp8<fp4", 0.0, "PASS")
    monkeypatch.setattr(method_comparison, "METHODS", ["bf16", "quartet", "lss_int4"])
    results = method_comparison.main(["--steps", "1", "--device", "cpu"])
    assert set(results) == {"bf16", "quartet", "lss_int4"}
    assert "quartet vs best 4-bit prior" in capsys.readouterr().out
