"""PyTorch port vs the JAX reference: Quartet's variants, the metrics, the
scaling law and the script twins.

Inputs are drawn with numpy from a seed and fed to both packages on the
CPU; the reference runs its plain path (``use_kernels=False``), jitted.

* ``quartet_linear`` under each variant the paper compares Quartet with
  (the FP8 baseline, RTN- and SR-AbsMax forwards, an RTN or unquantized
  backward, the fixed or no backward Hadamard, MXFP8 with QuEST) and
  under NVFP4 at group 16: y, dx and dW against ``jax.vjp``, rtol 1e-5 and
  atol 1e-6·max|ref| as the Quartet linear is held (the SR operands
  bit-exact with the reference's CPU dot order, ``use_reference_dot_order``,
  on 96-row operands; f32 sums in another order), NaN at the same places.
  NVFP4 reproduces the reference's lost gradients (ROADMAP C7): a backward
  block whose ¾·absmax/6 rounds to 0 in E4M3 gets scale 0, so its values
  are ±6·0 = 0 (a gradient scaled by 1e-3 vanishes) and NaN where the block
  holds an exact zero (0/0: the N padding's zero block makes all of dx
  NaN).  With
  ``accum_dtype="bfloat16"`` each GEMM rounds to bf16 and the H⁻¹ runs in
  bf16, whose products sum in another order: within one bf16 step (2⁻⁷).
* ``quartet_linear_experts`` under the variants against ``jax.vmap`` of the
  reference's ``quartet_linear`` (SR-AbsMax keyed at each expert's seed).
* ``use_kernels=True`` raises on every configuration the kernels do not
  compute (ROADMAP C6), in both linears and in ``kernel_config``.
* ``metrics`` against the reference: MSE, cosine, the gradient alignment
  (rtol 1e-6) and PMA (atol 1e-6; the reference sums each inner product in
  f32 one fused multiply-add after another, patched into the port here as
  ``use_reference_dot_order`` patches the Hadamard).
* ``scaling_law``: the port's copy gives the reference's fits and regions
  exactly.
* The script twins' ``run()`` on the CPU at their own small sizes: the
  original's rows, and the orderings they assert.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_numerics import use_reference_dot_order

import repro.core.quartet as JQ
from benchmarks import fig1_scaling_law as jfig1
from benchmarks import table2_quantizer_metrics as jtable2
from repro.core import formats as JF
from repro.core import metrics as JM
from repro.core import scaling_law as JS
from repro_torch.benchmarks import fig1_scaling_law as tfig1
from repro_torch.benchmarks import table2_quantizer_metrics as ttable2
from repro_torch.configs import get_reduced_config
from repro_torch.core import formats as TF
from repro_torch.core import metrics as TM
from repro_torch.core import quartet as TQ
from repro_torch.core import scaling_law as TS
from repro_torch.core import threefry
from repro_torch.examples import quickstart
from repro_torch.launch.serve_engine import kernel_config

VARIANTS = {
    "fp8": {"fwd_format": "mxfp8", "bwd_format": "mxfp8", "fwd_quantizer": "rtn_absmax",
            "bwd_rounding": "rtn", "bwd_hadamard": "none"},
    "fwd_rtn_absmax": {"fwd_quantizer": "rtn_absmax"},
    "fwd_sr_absmax": {"fwd_quantizer": "sr_absmax"},
    "bwd_rtn": {"bwd_rounding": "rtn"},
    "bwd_unquantized": {"bwd_rounding": "none", "bwd_hadamard": "none"},
    "bwd_fixed_hadamard": {"bwd_hadamard": "fixed"},
    "mxfp8_quest": {"fwd_format": "mxfp8", "bwd_format": "mxfp8"},
    "nvfp4_g16": {"fwd_format": "nvfp4", "bwd_format": "nvfp4", "group": 16},
}


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: many small ops, several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol, atol_rel, name=""):
    """allclose with atol = atol_rel·max|want|, NaN at the same places."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan, err_msg=name)
    if (~nan).any():
        atol = atol_rel * float(np.abs(want[~nan]).max())
        np.testing.assert_allclose(got[~nan], want[~nan], rtol=rtol, atol=atol, err_msg=name)


def _linear_case(n: int, scale: float):
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 48, 128)).astype(np.float32)
    w = (rng.standard_normal((128, n)) / 11).astype(np.float32)
    dy = (rng.standard_normal((2, 48, n)) * scale).astype(np.float32)
    return x, w, dy


def _linear_both(kw: dict, n: int, scale: float):
    x, w, dy = _linear_case(n, scale)
    jcfg = JQ.QuartetConfig(**kw)

    def jrun(a, b, d):
        y, f = jax.vjp(lambda a, b: JQ.quartet_linear(a, b, jnp.uint32(7), jcfg), a, b)
        return (y, *f(d))

    want = jax.jit(jrun)(x, w, dy)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    yt = TQ.quartet_linear(xt, wt, 7, TQ.QuartetConfig(**kw))
    got = (yt.detach(), *torch.autograd.grad(yt, [xt, wt], torch.from_numpy(dy)))
    return want, got


@pytest.mark.parametrize("scale", [1.0, 1e-3])
@pytest.mark.parametrize("variant", list(VARIANTS))
def test_quartet_linear_variant_matches_reference(variant, scale, monkeypatch):
    use_reference_dot_order(monkeypatch)
    kw = VARIANTS[variant]
    n = 96 if variant == "nvfp4_g16" else 80  # NVFP4: no zero padding block
    want, got = _linear_both(kw, n, scale)
    for name, w_, g in zip(("y", "dx", "dW"), want, got):
        _close(g.numpy(), w_, 1e-5, 1e-6, f"{variant}/{name}")
    assert all(np.isfinite(g.numpy()).all() for g in got)
    if variant == "nvfp4_g16" and scale == 1e-3:
        # every block of the rotated ¾·dy has absmax/6 below 2⁻¹⁰: E4M3 scale
        # 0, values ±6·0, and both gradients vanish, as in the reference (C7)
        assert not np.asarray(want[1]).any() and not got[1].any() and not got[2].any()


def test_nvfp4_padding_block_gives_nan_as_the_reference():
    """N = 80 pads dy to 96 with a zero block of 16: E4M3 scale 0, so SR of
    0/0 and NaN in all of dx, in the reference and in the port alike."""
    want, got = _linear_both(VARIANTS["nvfp4_g16"], 80, 1.0)
    assert np.isnan(np.asarray(want[1])).all() and torch.isnan(got[1]).all()
    _close(got[2].numpy(), want[2], 1e-5, 1e-6, "dW")


def test_quartet_linear_bf16_accumulation(monkeypatch):
    use_reference_dot_order(monkeypatch)
    want, got = _linear_both({"accum_dtype": "bfloat16"}, 80, 1.0)
    _close(got[0].numpy(), want[0], 0, 0, "y")
    for name, w_, g in zip(("dx", "dW"), want[1:], got[1:]):
        _close(g.numpy(), w_, 2.0**-7, 2.0**-8, name)


@pytest.mark.parametrize("variant", ["fwd_sr_absmax", "fp8", "nvfp4_g16", "bwd_unquantized"])
def test_quartet_linear_experts_variant_matches_reference_vmap(variant, monkeypatch):
    use_reference_dot_order(monkeypatch)
    kw = VARIANTS[variant]
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 64, 128)).astype(np.float32)
    w = (rng.standard_normal((3, 128, 96)) / 11).astype(np.float32)
    dy = rng.standard_normal((3, 64, 96)).astype(np.float32)
    seeds = np.array([5, 2**31 + 3, 77], np.uint32)
    jcfg = JQ.QuartetConfig(**kw)

    def jrun(a, b, d):
        y, f = jax.vjp(lambda a, b: jax.vmap(lambda xe, we, s: JQ.quartet_linear(
            xe, we, s, jcfg))(a, b, jnp.asarray(seeds)), a, b)
        return (y, *f(d))

    want = jax.jit(jrun)(x, w, dy)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    yt = TQ.quartet_linear_experts(xt, wt, torch.from_numpy(seeds.astype(np.int64)),
                                   TQ.QuartetConfig(**kw))
    got = (yt.detach(), *torch.autograd.grad(yt, [xt, wt], torch.from_numpy(dy)))
    for name, w_, g in zip(("y", "dx", "dW"), want, got):
        _close(g.numpy(), w_, 1e-5, 1e-6, f"{variant}/{name}")


@pytest.mark.parametrize("variant", [*VARIANTS, "bf16_accumulation", "group16"])
def test_kernels_raise_on_configs_they_do_not_compute(variant):
    kw = VARIANTS.get(variant, {"bf16_accumulation": {"accum_dtype": "bfloat16"},
                                "group16": {"group": 16}}.get(variant))
    cfg = TQ.QuartetConfig(use_kernels=True, **kw)
    assert not TQ.kernels_compute(cfg)
    x, w = torch.zeros(4, 64), torch.zeros(64, 32)
    with pytest.raises(ValueError, match="kernels compute Quartet only"):
        TQ.quartet_linear(x, w, 0, cfg)
    with pytest.raises(ValueError, match="kernels compute Quartet only"):
        TQ.quartet_linear_experts(x[None], w[None], torch.zeros(1, dtype=torch.int64), cfg)
    mcfg = get_reduced_config("llama-paper-200m")
    with pytest.raises(ValueError, match="kernels compute Quartet only"):
        kernel_config(dataclasses.replace(mcfg, quartet=TQ.QuartetConfig(**kw)))
    # Quartet itself and the bf16 passthrough are what the kernels run
    assert TQ.kernels_compute(TQ.QuartetConfig(use_kernels=True))
    assert TQ.kernels_compute(dataclasses.replace(TQ.BF16_CONFIG, use_kernels=True))
    assert kernel_config(mcfg).quartet.use_kernels


def test_configs_match_reference():
    for j, t in ((JQ.BF16_CONFIG, TQ.BF16_CONFIG), (JQ.FP8_CONFIG, TQ.FP8_CONFIG),
                 (JQ.QUARTET_CONFIG, TQ.QUARTET_CONFIG)):
        assert dataclasses.asdict(j) == dataclasses.asdict(t)
    with pytest.raises(ValueError):
        TQ.quartet_linear(torch.zeros(2, 32), torch.zeros(32, 32), 0,
                          TQ.QuartetConfig(bwd_rounding="stochastic"))


# ---------------------------------------------------------------------------
# metrics
# ---------------------------------------------------------------------------


def _fma_vdot(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """The reference's f32 inner product: one fused multiply-add after
    another from the first element (emulated in float64, where each
    product is exact)."""
    av = a.reshape(-1).double().numpy()
    bv = b.reshape(-1).double().numpy()
    acc = np.float32(0.0)
    for p in av * bv:
        acc = np.float32(np.float64(acc) + p)
    return torch.tensor(acc)


@pytest.mark.parametrize("quantizer", ["sr_absmax", "rtn_absmax", "quest", "rtn_absmax_pma"])
def test_pma_matches_reference(quantizer, monkeypatch):
    use_reference_dot_order(monkeypatch)
    monkeypatch.setattr(TM, "_vdot", _fma_vdot)
    x = np.random.default_rng(3).standard_normal(2048).astype(np.float32)
    want = float(JM.pma_misalignment(jnp.asarray(x), quantizer, jax.random.PRNGKey(3),
                                     JF.MXFP4, num_samples=6))
    got = float(TM.pma_misalignment(torch.from_numpy(x), quantizer, threefry.prng_key(3),
                                    TF.MXFP4, num_samples=6))
    assert abs(got - want) <= 1e-6, (got, want)


def test_metrics_match_reference():
    rng = np.random.default_rng(4)
    a = rng.standard_normal((16, 64)).astype(np.float32)
    b = (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)
    ja, jb, ta, tb = jnp.asarray(a), jnp.asarray(b), torch.from_numpy(a), torch.from_numpy(b)
    for jf, tf in ((JM.mse, TM.mse), (JM.relative_mse, TM.relative_mse),
                   (JM.cosine_similarity, TM.cosine_similarity)):
        np.testing.assert_allclose(float(tf(ta, tb)), float(jf(ja, jb)), rtol=1e-6)
    gq = [rng.standard_normal((8, 32)).astype(np.float32) for _ in range(3)]
    gr = [(g * 0.9 + 0.05 * rng.standard_normal(g.shape)).astype(np.float32) for g in gq]
    want = JM.gradient_alignment_by_depth([jnp.asarray(g) for g in gq],
                                          [jnp.asarray(g) for g in gr])
    got = TM.gradient_alignment_by_depth([torch.from_numpy(g) for g in gq],
                                         [torch.from_numpy(g) for g in gr])
    for k in ("cosine", "magnitude"):
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6)


# ---------------------------------------------------------------------------
# the scaling law and the script twins
# ---------------------------------------------------------------------------


def test_scaling_law_matches_reference_exactly():
    law_j, law_t = JS.ScalingLaw(**JS.PAPER_COEFFS), TS.ScalingLaw(**TS.PAPER_COEFFS)
    n, d = np.logspace(7, 11, 9), np.logspace(9, 13, 9)
    np.testing.assert_array_equal(law_t.loss(n, d, 0.64, 0.94), law_j.loss(n, d, 0.64, 0.94))
    runs = [(n_, n_ * r, float(law_j.loss(n_, n_ * r))) for n_ in (30e6, 100e6)
            for r in (25, 100, 400)]
    assert TS.fit_baseline(runs).params() == JS.fit_baseline(runs).params()
    assert TS.fit_efficiencies(law_t, runs) == JS.fit_efficiencies(law_j, runs)
    assert TS.harmonic_training_speedup(2.0, 1.0) == JS.harmonic_training_speedup(2.0, 1.0)
    assert TS.SPEEDUPS == JS.SPEEDUPS


def _values(rows):
    """Rows without their timings: (name, value)."""
    return [(r[0], r[2]) for r in rows]


def test_fig1_twin_gives_the_originals_rows():
    got = tfig1.run()
    assert _values(got) == _values(jfig1.run())
    assert dict(_values(got))["fig1c/region_grows_with_fp4_bwd"] == "PASS"


def test_table2_twin_rows_and_ordering():
    got = ttable2.run("cpu", rows=512, flat=2048, num_samples=4)
    assert ttable2.PAPER == jtable2.PAPER
    assert [r[0] for r in got] == [f"table2/{q}/{m}" for q in jtable2.PAPER
                                   for m in ("mse", "misalignment")] + [
        "table2/ordering_quest<rtn<sr"]
    assert got[-1][2] == "PASS"


def test_quickstart_twin_runs_on_the_cpu():
    out = quickstart.main("cpu", steps=3)
    assert 0 < out["relative_error"] < 0.5
    assert out["mse"]["QuEST"] < out["mse"]["RTN"] < out["mse"]["SR"]
    assert np.isfinite([out["loss_first"], out["loss_last"], out["sr_misalignment"]]).all()
