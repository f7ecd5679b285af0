"""PyTorch port vs the JAX reference: MoE training.

The same seeded numpy inputs go through the reference and the port on the
CPU: B2's expert axis (``sr_hadamard_quantize_experts``), the stacked-expert
Quartet linear's Algorithm-1 backward, ``moe_ffn``'s output, aux loss and
gradients, the 8-bit AdamW, and three train steps of reduced qwen3-moe with
the aux loss, the 8-bit AdamW and a bf16 master.  The reference runs on its
plain path (``use_kernels=False``) except where its Pallas B2 is the thing
under test (interpret mode, as tests/test_kernels.py runs it).  The ``cuda``
test holds the expert-axis B2 to its plain version and to 2-d launches on
the card, and skips here.

Tolerances:
* B2's expert axis, plain version against the reference's Pallas kernel
  expert by expert, and the expert-axis launch (emulated through a stand-in
  for its C entry) against the plain version: bit for bit; the per-expert
  counter-hash signs and uniforms, seeds of 2^31 and more included: bit for
  bit.
* ``quartet_linear_experts`` dx and dW against the reference's vmapped
  ``quartet_linear``: rtol 1e-5, atol 1e-6·max|ref|, as the dense backward's
  test (bit-exact stochastic-rounding operands with the reference's CPU dot
  order, ``use_reference_dot_order``, on operands of 64 rows or more; f32
  sums in another order), on both of the port's paths (its plain path and
  the kernels' plain versions).
* ``moe_ffn``: y atol 1e-5 and aux rtol 1e-6, as tests/test_torch_moe.py;
  gradients of x, the router and the gate/up/down stacks rtol 1e-4,
  atol 1e-4·max|ref| per leaf, as the dense model's gradients.
* The 8-bit AdamW: int8 codes bit for bit; scales rtol 1e-6 (the f32 moments
  round the same; the scale's absmax is exact); updates rtol 1e-5,
  atol 1e-6·max|ref| (the port's bias corrections round from f64, the
  reference's from f32).
* Three train steps (the bf16 method), each from the reference's state: loss, aux, nll and
  grad-norm rtol 1e-4 (the dense train test's); params and moments rtol
  1e-4, atol 1e-4·max|ref| per leaf.  For the 8-bit run with its bf16
  master also one bf16 step at the element (an f32 update that differs in
  the last bits rounds to the neighbouring bf16 value when it lies on a
  rounding boundary) and its moment codes within one code of the
  reference's; in both runs a small share of elements is exempt for an
  update whose sign a rounding flipped (the test's docstring says why and
  how many).
"""

import dataclasses
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_moe import _ExpertEntries
from test_torch_numerics import use_reference_dot_order

import repro.core.quartet as JQ
from repro.configs import get_reduced_config as jget_reduced
from repro.core import fastrng as JR
from repro.data import pipeline as JD
from repro.kernels.sr_hadamard_quant import sr_hadamard_quantize as jsr
from repro.models import build_model as jbuild
from repro.models import moe as JM
from repro.optim import adamw as jadamw
from repro.optim import adamw8bit as jadamw8bit
from repro.optim import cosine_warmup as jcosine
from repro.optim.adamw import _dq8 as jdq8
from repro.optim.adamw import _q8 as jq8
from repro.train.state import make_train_state as jmake_train_state
from repro.train.steps import make_train_step as jmake_train_step
from repro_torch.checkpoint import Checkpointer
from repro_torch.checkpoint.checkpointer import _leaves, _unflatten
from repro_torch.configs import get_reduced_config
from repro_torch.convert import _leaf, init_params
from repro_torch.core import fastrng
from repro_torch.core import quartet as TQ
from repro_torch.data import pipeline as TD
from repro_torch.kernels import hadamard_quant as HQ
from repro_torch.kernels import mxfp4_matmul as MM
from repro_torch.kernels import sr_hadamard_quant as SR
from repro_torch.models import build_model
from repro_torch.models import moe as TM
from repro_torch.optim import adamw, adamw8bit, cosine_warmup
from repro_torch.optim.adamw import _dq8, _q8
from repro_torch.train.loop import train
from repro_torch.train.state import make_train_state
from repro_torch.train.steps import make_train_step
from repro_torch.tree import tree_leaves, tree_unflatten

ARCH = "qwen3-moe-235b-a22b"
SEEDS = [7, 2**31 + 5, 2**32 - 3]  # one expert each; two of them at or above 2^31
_REFERENCE = {}  # reference results shared by a test's parametrizations


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests run many small ops, which several
    threads a worker only slow down when the suite runs on several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, rtol, atol_frac):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_frac * np.abs(want).max())


# ---------------------------------------------------------------------------
# B2's expert axis
# ---------------------------------------------------------------------------


def test_fastrng_tensor_seeds_equal_reference_bits():
    """One batched draw over a tensor of seeds gives, in slice e, the
    reference's uint32 bits at seeds[e] (seeds of 2^31 and more wrap in an
    int64 product; here they must not)."""
    seeds = torch.tensor(SEEDS + [2**31, 0])
    bits = fastrng.random_bits(seeds, (3, 40), salt=4)
    signs = fastrng.rademacher(seeds, 96, salt=11)
    assert bits.shape == (5, 3, 40) and signs.shape == (5, 96)
    for e, s in enumerate(seeds.tolist()):
        want = np.asarray(JR.random_bits(jnp.uint32(s), (3, 40), salt=4)).astype(np.int64)
        np.testing.assert_array_equal(bits[e].numpy(), want)
        np.testing.assert_array_equal(signs[e].numpy(),
                                      np.asarray(JR.rademacher(jnp.uint32(s), 96, salt=11)))
        assert torch.equal(bits[e], fastrng.random_bits(s, (3, 40), salt=4))


def _b2_operands():
    """Three experts' operands [3, 64, 96]: row-major, and the same values
    as the transposed view of a [3, 96, 64] stack (unit stride along its
    rows, as Wq, xqᵀ and dyᵀ reach B2)."""
    rng = np.random.default_rng(21)
    x = (rng.standard_normal((3, 64, 96)) * 2.3).astype(np.float32)
    x[1, 5] *= 1e-30  # groups at the E8M0 floor
    xt = torch.from_numpy(np.ascontiguousarray(x.transpose(0, 2, 1))).transpose(-1, -2)
    return {"rows": torch.from_numpy(x), "transposed": xt}


def test_b2_experts_plain_equals_reference_kernel_per_expert():
    """The batched plain version, expert by expert, equals the reference's
    Pallas B2 (interpret mode) fed expert e's signs and counter-hash
    uniforms at seeds[e], bit for bit, on a row-major stack and on the
    transposed view of one (the reference reads the same logical
    operand)."""
    ops = _b2_operands()
    E, M, K = ops["rows"].shape
    seeds = torch.tensor(SEEDS)
    signs = fastrng.rademacher(seeds, K, salt=11)
    got = {k: SR.sr_hadamard_quantize_experts(x, signs, seeds, salt=3) for k, x in ops.items()}
    for e, s in enumerate(SEEDS):
        xe = jnp.asarray(ops["rows"][e].numpy())
        u = JR.uniform(jnp.uint32(s), (M, K), 3)
        want = jsr(xe, jnp.asarray(signs[e].numpy()), u, block_m=64, block_k=96)
        for codes, scales in got.values():
            assert codes.shape == (E, M, K) and scales.shape == (E, M, K // 32)
            np.testing.assert_array_equal(codes[e].numpy(), np.asarray(want[0]))
            np.testing.assert_array_equal(scales[e].numpy(), np.asarray(want[1]))
        for g, w in zip(got["transposed"], SR.sr_hadamard_quantize_plain(
                ops["transposed"][e], signs[e], s, salt=3)):
            assert torch.equal(g[e], w)


class _Entries(_ExpertEntries):
    """:class:`_ExpertEntries` with B2's expert-axis C entry: each expert's
    slice, its signs row and its seed read from the raw memory the wrapper
    passes, through the 2-d plain version, written where the kernel writes."""

    def b2(self, x, is_bf16, E, M, K, se, sm, sk, signs, seeds, salt, prescale, codes, scales,
           vector, offset, row_len, stream):
        dt = torch.bfloat16 if is_bf16 else torch.float32
        es = 2 if is_bf16 else 4
        self.calls.append({"entry": "b2", "grid_z": E, "vector": vector})
        slice_ok = (sk == 1 and (M == 1 or sm * es % 16 == 0)) or (
            sm == 1 and M % 8 == 0 and sk * es % 16 == 0)
        if vector and not (x % 16 == 0 and slice_ok and se * es % 16 == 0 and signs % 16 == 0):
            return 1  # cudaErrorInvalidValue
        sg = self._view(signs, torch.float32, (E, K), (K, 1))
        sd = self._view(seeds, torch.int32, (E,), (1,))
        for e in range(E):
            xe = self._view(x, dt, (M, K), (sm, sk), e * se)
            c, s = SR.sr_hadamard_quantize_plain(xe, sg[e], int(sd[e]) & 0xFFFFFFFF, prescale,
                                                 salt, offset, row_len)
            self._write(codes + e * M * K, c)
            self._write(scales + 4 * e * M * (K // 32), s)
        return 0


@pytest.fixture
def emulated(monkeypatch):
    """The expert-axis wrappers' card path on CPU tensors, the C entries
    emulated."""
    fake = _Entries()
    for mod in (HQ, MM, SR):
        monkeypatch.setattr(mod, "_device", lambda name, t: True)
    monkeypatch.setattr(HQ, "_experts_entry", lambda: fake.b1)
    monkeypatch.setattr(MM, "_experts_entry", lambda: fake.b3)
    monkeypatch.setattr(SR, "_experts_entry", lambda: fake.b2)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    return fake


def _experts_case(E=3, T=64, K=96, N=64, seed=23):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((E, T, K)).astype(np.float32)
    w = (rng.standard_normal((E, K, N)) * 0.1).astype(np.float32)
    dy = rng.standard_normal((E, T, N)).astype(np.float32)
    return x, w, dy


def _experts_grads(x, w, dy, cfg, seeds=SEEDS):
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = TQ.quartet_linear_experts(xt, wt, torch.tensor(seeds), cfg)
    return (y.detach(), *torch.autograd.grad(y, (xt, wt), torch.from_numpy(dy)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_b2_expert_launch_emulated_and_backward_on_it(emulated, dtype):
    """Each expert-axis B2 call is one launch (the experts on the grid), in
    its vector body at all four backward operands, and equals the plain
    version bit for bit; ``_backward_experts_kernels`` on the emulated
    launches equals it on the plain versions, and the experts' backward on
    the kernels holds to the plain path's."""
    ops = _experts_case()
    x, w, dy = (torch.from_numpy(a).to(dtype) for a in ops)
    seeds = torch.tensor(SEEDS)
    cfg = TQ.QuartetConfig(use_kernels=True)
    _, res = TQ._forward_experts_kernels(x, w, cfg)
    launches = (SR.sr_hadamard_quantize.launches, SR.sr_hadamard_quantize.vector_launches,
                MM.mxfp4_matmul.launches)
    emulated.calls.clear()
    got = TQ._backward_experts_kernels(cfg, seeds, res, dy)
    assert SR.sr_hadamard_quantize.launches - launches[0] == 4
    assert SR.sr_hadamard_quantize.vector_launches - launches[1] == 4
    assert MM.mxfp4_matmul.launches - launches[2] == 2
    assert [c["grid_z"] for c in emulated.calls] == [3] * 6
    # the same arithmetic on the plain versions (CPU tensors, no emulation)
    for mod in (HQ, MM, SR):
        emulated_device = mod._device
        mod._device = lambda name, t: False
    try:
        want = TQ._backward_experts_kernels(cfg, seeds, res, dy)
    finally:
        for mod in (HQ, MM, SR):
            mod._device = emulated_device
    for g, w_ in zip(got, want):
        assert torch.equal(g, w_)
    # an operand in the tile body: rows 4 bytes off a 16-byte boundary
    op = torch.cat([x, x[..., :32]], dim=-1)[..., 1:97]
    signs = fastrng.rademacher(seeds, 96, salt=11)
    for g, w_ in zip(SR.sr_hadamard_quantize_experts(op, signs, seeds, salt=2),
                     SR.sr_hadamard_quantize_experts_plain(op, signs, seeds, salt=2)):
        assert torch.equal(g, w_)
    assert emulated.calls[-1]["vector"] == 0


@pytest.mark.cuda
def test_b2_expert_kernel_matches_plain_and_2d_launches_on_card():
    """On the card: the expert-axis B2 at the four backward operands of a
    small stack equals its plain version and E launches of the 2-d kernel,
    bit for bit, and the experts' backward on the kernels equals it on the
    plain versions."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, w, dy = (torch.from_numpy(a).cuda().to(torch.bfloat16) for a in _experts_case())
    seeds = torch.tensor(SEEDS, device="cuda")
    for op in (dy, w.transpose(-1, -2).contiguous().transpose(-1, -2), x.transpose(-1, -2)):
        signs = fastrng.rademacher(seeds, op.shape[2], salt=11, device="cuda")
        got = SR.sr_hadamard_quantize_experts(op, signs, seeds, salt=2)
        for g, p in zip(got, SR.sr_hadamard_quantize_experts_plain(op, signs, seeds, salt=2)):
            assert torch.equal(g, p)
        for e, s in enumerate(SEEDS):
            for g, d in zip(got, SR.sr_hadamard_quantize(op[e], signs[e], s, salt=2)):
                assert torch.equal(g[e], d)
    cfg = TQ.QuartetConfig(use_kernels=True)
    _, res = TQ._forward_experts_kernels(x, w, cfg)
    plain = types.SimpleNamespace(
        sr_hadamard_quantize_experts=SR.sr_hadamard_quantize_experts_plain,
        mxfp4_matmul_experts=MM.mxfp4_matmul_experts_plain)
    for g, p in zip(TQ._backward_experts_kernels(cfg, seeds, res, dy),
                    TQ._backward_experts_kernels(cfg, seeds, res, dy, ops=plain)):
        assert torch.equal(g, p)


@pytest.mark.parametrize("use_kernels", [False, True])
def test_quartet_linear_experts_backward_vs_reference_vmap(use_kernels, monkeypatch):
    """dx and dW of the stacked-expert linear, on either of the port's
    paths, against ``jax.vmap`` of the reference's ``quartet_linear`` (plain
    path) at the same per-expert seeds."""
    use_reference_dot_order(monkeypatch)
    x, w, dy = _experts_case()
    if "vmap" not in _REFERENCE:
        jcfg = JQ.QuartetConfig()

        def jrun(a, b, d):
            y, f = jax.vjp(lambda a, b: jax.vmap(lambda xe, we, s: JQ.quartet_linear(
                xe, we, s, jcfg))(a, b, jnp.asarray(SEEDS, jnp.uint32)), a, b)
            return (y, *f(d))

        _REFERENCE["vmap"] = jax.jit(jrun)(x, w, dy)
    want = _REFERENCE["vmap"]
    got = _experts_grads(x, w, dy, TQ.QuartetConfig(use_kernels=use_kernels))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=1e-5)
    for g, w_ in zip(got[1:], want[1:]):
        _close(g.numpy(), w_, 1e-5, 1e-6)


def test_quartet_linear_experts_bf16_passthrough_backward():
    """``fwd_quantizer="none"``: the bmm backward, f32 products."""
    x, w, dy = _experts_case()
    _, dx, dw = _experts_grads(x, w, dy, TQ.BF16_CONFIG)
    np.testing.assert_allclose(dx.numpy(), np.einsum("etn,ekn->etk", dy, w), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(dw.numpy(), np.einsum("etk,etn->ekn", x, dy), rtol=1e-5,
                               atol=1e-5)


# ---------------------------------------------------------------------------
# moe_ffn's gradients
# ---------------------------------------------------------------------------


def _tree(np_tree):
    from repro_torch.convert import _leaf

    if isinstance(np_tree, dict):
        return {k: _tree(v) for k, v in np_tree.items()}
    return _leaf(np_tree, "cpu")


def test_moe_ffn_grads_match_reference(monkeypatch):
    """y, aux and the gradients of ⟨y, r⟩ + 0.3·aux with respect to x, the
    router and the gate/up/down stacks, against ``jax.grad`` of the
    reference's ``moe_ffn`` from the same weights (reduced qwen3-moe, f32, 64
    tokens, so every expert takes 32 rows), under the bf16 method: the
    routing, dispatch, combine and router gradients with no stochastic
    rounding in the way (the Quartet expert backward is held to the
    reference's by the vmapped expert-linear test above).  A jitted
    compile of the reference's Quartet MoE backward takes most of this
    file's budget."""
    use_reference_dot_order(monkeypatch)
    jcfg = jget_reduced(ARCH, dtype="float32")
    jp = JM.init_moe_ffn(jax.random.PRNGKey(0), jcfg, jnp.float32)
    tcfg = get_reduced_config(ARCH, dtype="float32")
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 32, jcfg.d_model)).astype(np.float32)
    r = rng.standard_normal(x.shape).astype(np.float32)

    def jloss(p, xx):
        y, aux = JM.moe_ffn(p, xx, jnp.uint32(9), jcfg, method="bf16")
        return jnp.sum(y * r) + 0.3 * aux, (y, aux)

    (_, (jy, jaux)), (jgp, jgx) = jax.jit(jax.value_and_grad(jloss, argnums=(0, 1),
                                                             has_aux=True))(jp, x)
    tp = _tree(jax.device_get(jp))
    leaves = [t.clone().requires_grad_() for t in tree_leaves(tp)]
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = TM.moe_ffn(tree_unflatten(tp, leaves), xt, 9, tcfg, method="bf16")
    grads = torch.autograd.grad((y * torch.from_numpy(r)).sum() + 0.3 * aux, [xt, *leaves])
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=0, atol=1e-5)
    assert abs(float(aux) - float(jaux)) <= 1e-6 * abs(float(jaux))
    _close(grads[0].numpy(), jgx, 1e-4, 1e-4)
    jleaves = jax.tree.leaves(jgp)
    assert len(jleaves) == len(leaves) == 4  # down, gate, router.w, up
    for g, jg in zip(grads[1:], jleaves):
        assert float(np.abs(np.asarray(jg)).max()) > 0
        _close(g.numpy(), jg, 1e-4, 1e-4)


def test_dispatch_backward_sums_slots_in_expert_order():
    """The dispatch gather's backward equals autograd's own scatter-add of
    the gathered gradients (f32), and in bf16 adds a token's slots in
    ascending expert order, one bf16 add at a time."""
    cfg = dataclasses.replace(get_reduced_config(ARCH), capacity_factor=0.5)
    tp = _tree(jax.device_get(JM.init_moe_ffn(jax.random.PRNGKey(0), jget_reduced(ARCH),
                                              jnp.float32)))
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.standard_normal((1, 128, cfg.d_model)).astype(np.float32))
    _, _, (sel_idx, sel_gate) = TM.moe_ffn(tp, x, 3, cfg, method="bf16", return_routing=True)
    G, E, c = sel_idx.shape
    slots = TM._slots(sel_idx, sel_gate, 128, cfg.experts_per_token)
    dxe = torch.from_numpy(rng.standard_normal((G, E, c, cfg.d_model)).astype(np.float32))
    dxe = dxe * (sel_gate > 0)[..., None]  # the ungated slots' gradients are zero
    xg = x.reshape(G, 128, -1).requires_grad_()
    (got,) = torch.autograd.grad(TM._Dispatch.apply(xg, sel_idx, *slots), xg, dxe)
    want = torch.zeros_like(xg).index_put_((torch.zeros_like(sel_idx), sel_idx), dxe,
                                           accumulate=True)
    np.testing.assert_allclose(got.numpy(), want.detach().numpy(), rtol=1e-6, atol=1e-6)
    d16 = dxe.to(torch.bfloat16)
    x16 = xg.detach().to(torch.bfloat16).requires_grad_()
    (got16,) = torch.autograd.grad(TM._Dispatch.apply(x16, sel_idx, *slots), x16, d16)
    ref16 = torch.zeros_like(x16)
    for e in range(E):  # ascending expert, one bf16 add at a time
        for j in range(c):
            if sel_gate[0, e, j] > 0:
                t = sel_idx[0, e, j]
                ref16[0, t] = ref16[0, t] + d16[0, e, j]
    assert torch.equal(got16, ref16)


# ---------------------------------------------------------------------------
# the 8-bit AdamW
# ---------------------------------------------------------------------------


def test_adamw8bit_matches_reference():
    """``_q8`` / ``_dq8`` and three updates against the reference, on leaves
    whose last axis is not a multiple of the 256-block."""
    rng = np.random.default_rng(8)
    params = {"a": rng.standard_normal((4, 300)).astype(np.float32),
              "b": {"c": rng.standard_normal((2, 3, 512)).astype(np.float32)}}
    grads = [{"a": rng.standard_normal((4, 300)).astype(np.float32) * 3,
              "b": {"c": rng.standard_normal((2, 3, 512)).astype(np.float32)}}
             for _ in range(3)]
    for leaf in (params["a"], params["b"]["c"]):
        jq, js = jq8(jnp.asarray(leaf))
        q, s = _q8(torch.from_numpy(leaf))
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        _close(s.numpy(), js, 1e-6, 0.0)
        _close(_dq8(q, s, leaf.shape).numpy(), jdq8(jq, js, leaf.shape, leaf.size), 1e-6, 0.0)
    t = lambda tr: {k: t(v) if isinstance(v, dict) else torch.from_numpy(v)  # noqa: E731
                    for k, v in tr.items()}
    jopt, topt = jadamw8bit(jcosine(1e-3, 10)), adamw8bit(cosine_warmup(1e-3, 10))
    js, ts = jopt.init(params), topt.init(t(params))
    jupdate = jax.jit(jopt.update)
    for g in grads:
        ju, js = jupdate(g, js, params)
        tu, ts = topt.update(t(g), ts, t(params))
        for a, b in zip(tree_leaves(tu), jax.tree.leaves(ju)):
            _close(a.numpy(), b, 1e-5, 1e-6)
        for a, b in zip(tree_leaves({"mu": ts["mu"], "nu": ts["nu"]}),
                        jax.tree.leaves({"mu": js["mu"], "nu": js["nu"]})):
            if a.dtype == torch.int8:
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))
            else:
                _close(a.numpy(), b, 1e-6, 0.0)
    assert ts["step"] == 3


# ---------------------------------------------------------------------------
# the model: aux under remat, three train steps, checkpoint, launcher
# ---------------------------------------------------------------------------

VOCAB, BATCH, SEQ = 512, 4, 32


@pytest.fixture(scope="module")
def moe_pair():
    """Reduced qwen3-moe (f32 compute) in both packages, from one set of
    weights (drawn by the port, handed to the reference)."""
    tcfg = get_reduced_config(ARCH, dtype="float32")
    tp = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp)
    return jbuild(jget_reduced(ARCH, dtype="float32")), jp, build_model(tcfg), tp


def test_aux_is_carried_through_remat(moe_pair):
    """Under remat the aux loss and every gradient (the aux's included) are
    the bits of the run that keeps its activations (the kernel path;
    tests/test_torch_train.py holds remat on both paths for the dense
    model); serving's forward still returns two values."""
    _, _, tm, tp = moe_pair
    tokens = torch.from_numpy(np.random.default_rng(3).integers(0, VOCAB, (2, SEQ)))
    assert len(tm.forward(tp, tokens, 5)) == 2
    for use_kernels in (True,):  # the card's path; the dense remat test takes both
        got = []
        for remat in (True, False):
            cfg = dataclasses.replace(tm.cfg, remat=remat,
                                      quartet=TQ.QuartetConfig(use_kernels=use_kernels))
            leaves = [t.clone().requires_grad_() for t in tree_leaves(tp)]
            logits, _, aux = build_model(cfg).forward(tree_unflatten(tp, leaves), tokens, 5,
                                                      return_aux=True)
            assert aux.dtype == torch.float32 and float(aux) > 0
            got.append((aux.detach(), torch.autograd.grad(logits.mean() + aux, leaves)))
        assert torch.equal(got[0][0], got[1][0])
        for a, b in zip(got[0][1], got[1][1]):
            assert torch.equal(a, b)


def _close_but(got, want, rtol, atol_frac, step=0.0, flipped=0.0):
    """Within rtol and atol_frac·max|want|, or ``step`` of the larger
    magnitude (2^-7, one bf16 step, for a bf16 master element whose f32
    update lies on a rounding boundary), at all but a ``flipped`` share of
    the elements, at least one when it is not 0 (see
    :func:`test_train_steps_match_reference`)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(jnp.asarray(want).astype(jnp.float32))
    tol = atol_frac * np.abs(want).max() + rtol * np.abs(want)
    bad = np.abs(got - want) > np.maximum(tol, np.maximum(np.abs(got), np.abs(want)) * step)
    assert bad.sum() <= np.ceil(flipped * bad.size), (float(np.abs(got - want).max()),
                                                      int(bad.sum()))


def _port_state(jstate, like):
    """The reference's TrainState as the port's, leaf by leaf in the
    checkpoint order (the step counters as Python ints)."""
    leaves = [_leaf(a, "cpu") if np.ndim(a) else int(a) for a in jax.tree.leaves(jstate)]
    return _unflatten(like, iter(leaves))


@pytest.mark.parametrize("opt,master", [("adamw8bit", "bfloat16"), ("adamw", "float32")])
def test_train_steps_match_reference(moe_pair, opt, master, monkeypatch):
    """Three steps (cosine warmup, clip 1.0, aux weight 0.01) on the same
    batches against the reference's ``make_train_step``: the 8-bit AdamW
    with a bf16 master, and the f32 AdamW with an f32 master.  Each step
    starts the port from the reference's state (params, moments, step), so
    each step's arithmetic is held to the reference's: loss, aux (summed
    over the 2 layers), nll and grad-norm, then every parameter and
    moment.  The steps run the bf16 method: one compile of the reference's
    Quartet MoE train step takes ~12 s on the CPU, more than this file's
    budget allows beside the rest; the Quartet expert backward is held to
    the reference's by the vmapped expert-linear test, and the whole
    Quartet MoE train step on the card against the CPU by
    ``chip_smoke.py``.  Remat is off on both sides (it changes no bit:
    :func:`test_aux_is_carried_through_remat`).

    Not a free run: AdamW's first updates follow the sign of each gradient
    element, and the 8-bit moments amplify a last-bit difference without
    bound (an element whose second moment quantizes to code 0 while its
    first does not moves by lr·m/eps, about 10 here), so two runs whose
    gradients differ in the last bit of one element are apart by more than
    any tolerance two steps later.  Even from equal states a gradient
    element near 0 can take the other sign from an f32 rounding (the two
    libraries sum attention, norms and the loss in other orders), which
    flips its update (one element of 32768 in an attention weight, by
    6.2e-5, in the f32 run); under Quartet a one-ulp difference can also
    flip a stochastic-rounding decision and move a gradient row by a grid
    step (ROADMAP C4).  So up to 1 in 10^4 elements of a leaf (at least
    one) may lie outside the tolerance, and up to 1 in 10^3 moment codes
    more than one code from the reference's."""
    use_reference_dot_order(monkeypatch)
    jm, jp, tm, tp = moe_pair
    jm = jbuild(dataclasses.replace(jm.cfg, remat=False))
    tm = build_model(dataclasses.replace(tm.cfg, remat=False))
    eight = opt == "adamw8bit"
    jopt = (jadamw8bit if eight else jadamw)(jcosine(1e-3, 10))
    topt = (adamw8bit if eight else adamw)(cosine_warmup(1e-3, 10))
    jstep = jax.jit(jmake_train_step(jm, jopt, method="bf16", aux_weight=0.01))
    # one compile, not one per op and leaf shape
    jstate = jax.jit(lambda p: jmake_train_state(p, jopt, master_dtype=master))(jp)
    step = make_train_step(tm, topt, method="bf16", aux_weight=0.01)
    state = make_train_state(tp, topt, master)

    def close(got, want):
        _close_but(got, want, 1e-4, 1e-4, step=2.0**-7 if eight else 0.0, flipped=1e-4)

    batcher = JD.TokenBatcher(JD.SyntheticC4Dataset(VOCAB, seed=0), BATCH, SEQ)
    for i in range(3):
        b = batcher.batch(i)
        state = _port_state(jstate, state)
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, met = step(state, {k: torch.from_numpy(v) for k, v in b.items()})
        for key in ("loss", "aux", "nll", "grad_norm"):
            _close(float(met[key]), float(jmet[key]), 1e-4, 0.0)
        assert float(met["aux"]) > 0
        assert state.step == i + 1 and int(jstate.step) == i + 1
        for p, jp_ in zip(tree_leaves(state.params), jax.tree.leaves(jstate.params)):
            assert p.dtype == getattr(torch, master)
            close(p.float().numpy(), jp_)
        moments = {"mu": state.opt_state["mu"], "nu": state.opt_state["nu"]}
        jmoments = {"mu": jstate.opt_state["mu"], "nu": jstate.opt_state["nu"]}
        for m, jm_ in zip(tree_leaves(moments), jax.tree.leaves(jmoments)):
            if m.dtype == torch.int8:  # codes: within one of the reference's
                off = np.abs(m.numpy().astype(int) - np.asarray(jm_).astype(int)) > 1
                assert off.sum() <= np.ceil(1e-3 * off.size), int(off.sum())
            else:
                close(m.numpy(), jm_)


def test_8bit_state_checkpoint_round_trip_and_launcher(moe_pair, tmp_path, monkeypatch,
                                                       capsys):
    """The 8-bit state ({"q", "s"} leaves, int8 and f32) and the bf16 master
    saved and restored in the reference's leaf order, bit for bit; training
    resumed from it continues as the unbroken run; the launcher trains
    reduced qwen3-moe with ``--opt8bit`` on the CPU."""
    _, _, tm, tp = moe_pair
    batcher = TD.TokenBatcher(TD.SyntheticC4Dataset(VOCAB, seed=0), 2, SEQ)
    opt = adamw8bit(cosine_warmup(1e-3, 3))
    quiet = {"device": "cpu", "log_fn": lambda *_: None, "master_dtype": "bfloat16"}
    whole, hist = train(tm, opt, batcher, 2, params=tp, **quiet)
    ck = str(tmp_path / "ck")
    first, _ = train(tm, opt, batcher, 1, params=tp, checkpoint_dir=ck, **quiet)
    back, meta = Checkpointer(ck).restore(first)
    assert meta["step"] == 1
    for a, b in zip(_leaves(back), _leaves(first)):
        assert type(a) is type(b)
        assert (a.dtype == b.dtype and torch.equal(a, b)) if isinstance(a, torch.Tensor) \
            else a == b
    assert {t.dtype for t in tree_leaves(back.opt_state["mu"])} == {torch.int8, torch.float32}
    again, rest = train(tm, opt, batcher, 2, params=tp, checkpoint_dir=ck, **quiet)
    assert [h["loss"] for h in rest] == [hist[1]["loss"]]
    for a, b in zip(tree_leaves(again.params), tree_leaves(whole.params)):
        assert torch.equal(a, b)
    monkeypatch.setattr(sys, "argv", ["train", "--reduced", "--arch", ARCH, "--opt8bit",
                                      "--device", "cpu", "--steps", "2", "--batch", "2",
                                      "--seq", "32"])
    from repro_torch.launch import train as launcher

    launcher.main()
    out = capsys.readouterr().out
    assert "final loss" in out and "qwen3-moe-235b-a22b-reduced" in out
