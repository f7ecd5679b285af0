"""PyTorch port vs the JAX reference: the MoE layer, its model, its configs,
and the expert-axis forms of B1 and B3.

Inputs come from numpy at a seed; reference params cross over leaf by leaf
(``repro_torch.convert``).  The reference runs with ``use_kernels=False``
(its plain path); the port on its plain path and on its kernels' plain
versions (``use_kernels=True`` on CPU tensors).

Tolerances:
* routing: ``sel_idx`` (which tokens each expert takes, in which order)
  equal; ``sel_gate`` within 2e-6 relative: XLA:CPU's ``exp`` differs from
  PyTorch's in the last bit on ~8% of inputs, so a softmax probability, and
  the gate normalised from it, can differ by a few ulps (no choice flips on
  these seeds).
* the combine: bit for bit against the reference's scatter-add on the same
  gated expert outputs (both add a token's summands in ascending expert
  order, rounding each add to the dtype).
* ``y``: 1e-5 absolute in f32 (the expert GEMMs sum in another order: the
  reference's per-expert dot, the port's ``bmm``); ``aux``: 1e-6 relative.
* model logits: 2e-5, as the dense model's test, on the port's plain path.
  The kernels' plain versions (``use_kernels=True`` on the CPU) sum the
  Hadamard in the card's butterfly order, which can differ from the
  reference's matrix product by an ulp and flip a QuEST rounding (ROADMAP
  C4): reduced arctic's dense-residual down projection flips one here, so
  the kernel path is held to the plain path in ``moe_ffn`` and in the
  serving tests (tests/test_torch_moe_serve.py) instead.
* the batched plain B1 and B3 against per-expert 2-d calls: bit for bit.

The ``cuda`` test holds the expert-axis kernels to their plain versions and
to E 2-d kernel launches on the card, and skips here.
"""

import ctypes
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget
from repro.configs import get_reduced_config as jget_reduced
from repro.models import build_model as jbuild
from repro.models import moe as JM
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.convert import init_params, params_from_jax
from repro_torch.kernels import hadamard_quant as HQ
from repro_torch.kernels import mxfp4_matmul as MM
from repro_torch.launch.serve_engine import kernel_config
from repro_torch.models import build_model
from repro_torch.models import moe as TM

ARCHS = ("qwen3-moe-235b-a22b", "arctic-480b")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: these tests run many small ops, which several
    threads a worker only slow down when the suite runs on several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _tree(np_tree):
    """A reference param subtree (numpy leaves) → the port's leaves on the CPU."""
    from repro_torch.convert import _leaf

    if isinstance(np_tree, dict):
        return {k: _tree(v) for k, v in np_tree.items()}
    return _leaf(np_tree, "cpu")


@pytest.fixture(scope="module", params=ARCHS)
def ffn(request):
    """One reduced MoE FFN's params (reference init) on both sides, f32."""
    arch = request.param
    jcfg = jget_reduced(arch, dtype="float32")
    jp = JM.init_moe_ffn(jax.random.PRNGKey(0), jcfg, jnp.float32)
    return arch, jcfg, jp, get_reduced_config(arch, dtype="float32"), _tree(jax.device_get(jp))


X_FFN = np.random.default_rng(1).standard_normal((3, 40, 128)).astype(np.float32)
_REFERENCE = {}


def _reference_ffn(arch, jcfg, jp, method):
    """The reference's ``moe_ffn`` on ``X_FFN`` (jitted, once per arch and
    method) with the outputs of its two ``jax.lax.top_k`` calls (the
    router's, then capacity selection's), recorded while it is traced."""
    if (arch, method) not in _REFERENCE:
        top_k = jax.lax.top_k

        def run(p, x):
            calls = []

            def rec(v, k):
                out = top_k(v, k)
                calls.append(out)
                return out

            jax.lax.top_k = rec
            try:
                y, aux = JM.moe_ffn(p, x, jnp.uint32(7), jcfg, method=method)
            finally:
                jax.lax.top_k = top_k
            return y, aux, calls

        out = jax.jit(run)(jp, jnp.asarray(X_FFN))
        _REFERENCE[arch, method] = jax.tree.map(np.asarray, out)
    return _REFERENCE[arch, method]


@pytest.mark.parametrize("method", ["bf16", "quartet"])
@pytest.mark.parametrize("use_kernels", [False, True])
def test_moe_ffn_routes_and_matches_reference(ffn, method, use_kernels):
    arch, jcfg, jp, tcfg, tp = ffn
    if use_kernels:
        tcfg = kernel_config(tcfg)
    jy, jaux, ((_, top_idx), (sel_val, sel_idx)) = _reference_ffn(arch, jcfg, jp, method)
    y, aux, (t_idx, t_gate) = TM.moe_ffn(tp, torch.from_numpy(X_FFN), 7, tcfg, method=method,
                                         return_routing=True)
    np.testing.assert_array_equal(t_idx.numpy(), sel_idx)
    np.testing.assert_allclose(t_gate.numpy(), np.where(sel_val > 0, sel_val, 0.0),
                               rtol=2e-6, atol=0)
    assert (sel_val > 0).sum() == top_idx.size  # no token dropped at this capacity
    np.testing.assert_allclose(y.numpy(), jy, rtol=0, atol=1e-5)
    assert abs(float(aux) - float(jaux)) <= 1e-6 * abs(float(jaux))


@pytest.mark.parametrize("dtype", [np.float32, jnp.bfloat16])
def test_combine_equals_reference_scatter_add(ffn, dtype):
    """The combine alone, bit for bit: the reference's ``out.at[gidx,
    sel_idx].add(ye)`` and the port's ascending-expert sum on the same gated
    expert outputs and selection (a capacity-tight routing, so some tokens
    drop and some experts hold zero-gated filler rows)."""
    arch, _, _, tcfg, tp = ffn
    cfg = dataclasses.replace(tcfg, capacity_factor=0.25)
    rng = np.random.default_rng(2)
    G, g = 2, 128
    x = rng.standard_normal((G, g, cfg.d_model)).astype(np.float32)
    _, _, (sel_idx, sel_gate) = TM.moe_ffn(tp, torch.from_numpy(x).reshape(1, G * g, -1), 3,
                                           cfg, method="bf16", group_tokens=g,
                                           return_routing=True)
    assert ((sel_gate > 0).sum(1) > 0).all() and (sel_gate == 0).any()
    c = sel_idx.shape[-1]
    raw = rng.standard_normal((G, cfg.num_experts, c, cfg.d_model)).astype(np.float32) * 4
    ye = (jnp.asarray(raw, dtype) * jnp.asarray(sel_gate.numpy())[..., None].astype(dtype))
    want = jnp.zeros((G, g, cfg.d_model), dtype).at[
        jnp.arange(G)[:, None, None], jnp.asarray(sel_idx.numpy())].add(ye)
    tdt = torch.float32 if dtype == np.float32 else torch.bfloat16
    ye_t = torch.from_numpy(np.array(ye.astype(jnp.float32))).to(tdt)
    got = TM._combine(ye_t, sel_idx, sel_gate, g, cfg.experts_per_token)
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_capacity_routing_ignores_padding_lanes():
    """Twin of the reference's ``test_moe_capacity_routing_ignores_padding_lanes``
    (tests/test_perf_features.py): at a capacity-tight config, with
    ``token_valid`` the valid lanes' outputs are bit-identical whatever the
    padding lanes hold; without it, the garbage lanes perturb routing."""
    cfg = dataclasses.replace(get_reduced_config("qwen3-moe-235b-a22b"), capacity_factor=0.25)
    B, S = 2, 256  # row 1 is all padding
    c = TM.moe_capacity(cfg, B * S)
    assert c < S * cfg.experts_per_token / cfg.num_experts * 2
    jcfg = dataclasses.replace(jget_reduced("qwen3-moe-235b-a22b"), capacity_factor=0.25)
    params = _tree(jax.device_get(JM.init_moe_ffn(jax.random.PRNGKey(0), jcfg, jnp.bfloat16)))
    rng = np.random.default_rng(1)
    x_valid = torch.from_numpy(rng.standard_normal((1, S, cfg.d_model)).astype(np.float32))
    mask = torch.cat([torch.ones((1, S), dtype=torch.bool), torch.zeros((1, S), dtype=torch.bool)])

    def run(pad_seed, token_valid):
        pad = 100.0 * np.random.default_rng(pad_seed).standard_normal((1, S, cfg.d_model))
        x = torch.cat([x_valid, torch.from_numpy(pad.astype(np.float32))]).to(torch.bfloat16)
        y, _ = TM.moe_ffn(params, x, 7, cfg, token_valid=token_valid)
        return y[0].float()

    assert torch.equal(run(2, mask), run(3, mask))
    assert not torch.equal(run(2, None), run(3, None))


@pytest.fixture(scope="module", params=ARCHS)
def model_pair(request):
    arch = request.param
    jm = jbuild(jget_reduced(arch, dtype="float32"))
    jp = jm.init(jax.random.PRNGKey(0))
    tokens = np.random.default_rng(0).integers(0, 512, (2, 24)).astype(np.int32)
    want = {m: np.asarray(jax.jit(lambda p, t, m=m: jm.forward(
        p, t, jnp.uint32(0), method=m)[0])(jp, jnp.asarray(tokens))) for m in ("bf16", "quartet")}
    tcfg = get_reduced_config(arch, dtype="float32")
    return tokens, want, tcfg, params_from_jax(jax.device_get(jp), tcfg, "cpu")


@pytest.mark.parametrize("method", ["bf16", "quartet"])
def test_moe_model_logits_match_reference(model_pair, method):
    tokens, want, tcfg, tp = model_pair
    got, _ = build_model(tcfg).forward(tp, torch.from_numpy(tokens), 0, method=method)
    assert got.dtype == torch.float32 and got.shape == (2, 24, tcfg.vocab_size)
    np.testing.assert_allclose(got.numpy(), want[method], rtol=0, atol=2e-5)


def test_moe_params_tree_and_init_laws(model_pair):
    """``init_params`` draws the reference's MoE tree and shapes; a tree of
    the wrong layout raises."""
    _, _, tcfg, tp = model_pair
    mine = init_params(tcfg, torch.Generator().manual_seed(0), "cpu")
    sig = lambda a: (tuple(a.shape), a.dtype)  # noqa: E731
    assert jax.tree.map(sig, mine) == jax.tree.map(sig, tp)
    for leaf in ("gate", "down"):
        ratio = mine["layers"]["moe"][leaf].std() / tp["layers"]["moe"][leaf].std()
        assert abs(float(ratio) - 1) < 0.05
    bad = dataclasses.replace(tcfg, num_experts=tcfg.num_experts * 2)
    with pytest.raises(ValueError, match="layers.moe.gate"):
        params_from_jax(jax.tree.map(lambda t: t.numpy(), tp), bad, "cpu")


@pytest.mark.parametrize("arch", ARCHS)
def test_configs_match_reference(arch):
    """Field for field (the port has no multi-device or state-family fields),
    and ``n_params`` with and without the embeddings."""
    for mine, ref in ((get_config(arch), jget(arch)),
                      (get_reduced_config(arch), jget_reduced(arch))):
        for f in dataclasses.fields(mine):
            if f.name != "quartet":
                assert getattr(mine, f.name) == getattr(ref, f.name), f.name
        for ne in (True, False):
            assert mine.n_params(non_embedding=ne) == ref.n_params(non_embedding=ne)


# ---------------------------------------------------------------------------
# the expert-axis forms of B1 and B3
# ---------------------------------------------------------------------------


def _expert_operands(E=3, M=40, K=96, N=64, seed=5):
    rng = np.random.default_rng(seed)
    x = torch.from_numpy(rng.standard_normal((E, M, K)).astype(np.float32))
    x[1, 3] *= 1e-30  # tiny groups: scales at the E8M0 floor
    x[2, 5] *= 1e30
    w = torch.from_numpy(rng.standard_normal((E, K, N)).astype(np.float32)).to(torch.bfloat16)
    return x, w


def test_batched_plain_b1_b3_equal_per_expert_calls():
    x, w = _expert_operands()
    E = x.shape[0]
    for operand in (x, w.transpose(-1, -2)):  # activations; the weights' transposed view
        got = HQ.hadamard_quest_quantize_experts(operand)
        for e in range(E):
            for g, want in zip(got, HQ.hadamard_quest_quantize_plain(operand[e])):
                assert torch.equal(g[e], want)
    xc, xs, _ = HQ.hadamard_quest_quantize_experts(x)
    wc, ws, _ = HQ.hadamard_quest_quantize_experts(w.transpose(-1, -2))
    got = MM.mxfp4_matmul_experts(xc, xs, wc.transpose(-1, -2), ws.transpose(-1, -2))
    for e in range(E):
        want = MM.mxfp4_matmul_plain(xc[e], xs[e], wc[e].t(), ws[e].t())
        assert torch.equal(got[e], want)


class _ExpertEntries:
    """Stand-ins for the two C entries: walk the grid's expert axis over the
    raw memory the wrapper passes, each expert's slice read at its expert
    stride through the strides given and run through the 2-d plain version,
    its outputs written at the offsets the kernel writes them."""

    def __init__(self):
        self.calls = []

    @staticmethod
    def _view(ptr, dtype, shape, strides, offset=0):
        extent = offset + sum((n - 1) * s for n, s in zip(shape, strides)) + 1
        es = torch.empty((), dtype=dtype).element_size()
        raw = (ctypes.c_char * (extent * es)).from_address(ptr)
        flat = torch.frombuffer(raw, dtype=torch.uint8).view(dtype)
        return flat.as_strided(shape, strides, offset)

    @staticmethod
    def _write(ptr, t):
        t = t.contiguous()
        ctypes.memmove(ptr, t.data_ptr(), t.numel() * t.element_size())

    def b1(self, x, is_bf16, E, M, K, se, sm, sk, codes, scales, mask, clip_c, vector, stream):
        dt = torch.bfloat16 if is_bf16 else torch.float32
        es = 2 if is_bf16 else 4
        self.calls.append({"entry": "b1", "grid_z": E, "vector": vector})
        slice_ok = (sk == 1 and (M == 1 or sm * es % 16 == 0)) or (
            sm == 1 and M % 8 == 0 and sk * es % 16 == 0)
        if vector and not (x % 16 == 0 and slice_ok and se * es % 16 == 0):
            return 1  # cudaErrorInvalidValue
        for e in range(E):
            xe = self._view(x, dt, (M, K), (sm, sk), e * se)
            c, s, m = HQ.hadamard_quest_quantize_plain(xe)
            self._write(codes + e * M * K, c)
            self._write(scales + 4 * e * M * (K // 32), s)
            self._write(mask + e * M * K, m)
        return 0

    def b3(self, a, as_, E, M, K, sae, sase, b, sbn, sbe, bs, ssk, ssn, sbse, N, c, stream):
        self.calls.append({"entry": "b3", "grid_z": E})
        G = K // 32
        for e in range(E):
            ae = self._view(a, torch.int8, (M, K), (K, 1), e * sae)
            ase = self._view(as_, torch.float32, (M, G), (G, 1), e * sase)
            be = self._view(b, torch.int8, (K, N), (1, sbn), e * sbe)
            bse = self._view(bs, torch.float32, (G, N), (ssk, ssn), e * sbse)
            self._write(c + 4 * e * M * N, MM.mxfp4_matmul_plain(ae, ase, be, bse))
        return 0


@pytest.fixture
def emulated(monkeypatch):
    """The expert-axis wrappers' card path on CPU tensors, the C entries
    emulated."""
    fake = _ExpertEntries()
    for mod in (HQ, MM):
        monkeypatch.setattr(mod, "_device", lambda name, t: True)
    monkeypatch.setattr(HQ, "_experts_entry", lambda: fake.b1)
    monkeypatch.setattr(MM, "_experts_entry", lambda: fake.b3)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    return fake


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_expert_launches_emulated_on_the_host(emulated, dtype):
    """Each expert-axis call is one launch, the experts on the grid, and
    equals the plain version bit for bit: activations [E, M, K] (a slice of
    a larger buffer, so the expert stride is not M·K), the weights' transposed
    view [E, N, K] (strides (K·N, 1, N)), then the GEMM on both."""
    x, w = _expert_operands()
    x = torch.cat([x, x[:, :8]], dim=1)[:, :40].to(dtype)  # expert stride 48·K
    w = w.to(dtype)
    b1, b3 = HQ.hadamard_quest_quantize.launches, MM.mxfp4_matmul.launches
    v1 = HQ.hadamard_quest_quantize.vector_launches
    xq = HQ.hadamard_quest_quantize_experts(x)
    wq = HQ.hadamard_quest_quantize_experts(w.transpose(-1, -2))
    for got, op in ((xq, x), (wq, w.transpose(-1, -2))):
        for g, want in zip(got, HQ.hadamard_quest_quantize_experts_plain(op)):
            assert torch.equal(g, want)
    y = MM.mxfp4_matmul_experts(xq[0], xq[1], wq[0].transpose(-1, -2), wq[1].transpose(-1, -2))
    want = MM.mxfp4_matmul_experts_plain(xq[0], xq[1], wq[0].transpose(-1, -2),
                                         wq[1].transpose(-1, -2))
    assert torch.equal(y, want)
    assert HQ.hadamard_quest_quantize.launches - b1 == 2
    assert MM.mxfp4_matmul.launches - b3 == 1
    # both operands take the vector body (16-byte runs in every slice)
    assert HQ.hadamard_quest_quantize.vector_launches - v1 == 2
    assert [c["grid_z"] for c in emulated.calls] == [3, 3, 3]
    with pytest.raises(ValueError, match="bad operands"):
        MM.mxfp4_matmul_experts(xq[0], xq[1], wq[0], wq[1].transpose(-1, -2))
    # operands B1 takes in its tile body: rows off a 16-byte boundary, and a
    # transposed view whose columns are 72 bytes apart
    v1 = HQ.hadamard_quest_quantize.vector_launches
    for op in (torch.cat([x, x[..., :32]], dim=-1)[..., 1:97],
               torch.cat([w, w[..., :4]], dim=-1)[..., :36].transpose(-1, -2)):
        for g, want in zip(HQ.hadamard_quest_quantize_experts(op),
                           HQ.hadamard_quest_quantize_experts_plain(op)):
            assert torch.equal(g, want)
    assert HQ.hadamard_quest_quantize.vector_launches == v1
    assert [c["vector"] for c in emulated.calls[-2:]] == [0, 0]


@pytest.mark.cuda
def test_expert_kernels_match_plain_and_2d_launches_on_card():
    """On the card: the expert-axis B1 and B3 at a small MoE shape equal their
    plain versions and E launches of the 2-d kernels, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x, w = _expert_operands(E=4, M=24, K=256, N=160)
    x, w = x.cuda().to(torch.bfloat16), w.cuda()
    for op in (x, w.transpose(-1, -2)):
        got = HQ.hadamard_quest_quantize_experts(op)
        plain = HQ.hadamard_quest_quantize_experts_plain(op)
        for e in range(op.shape[0]):
            for g, p, d in zip(got, plain, HQ.hadamard_quest_quantize(op[e])):
                assert torch.equal(g[e], p[e]) and torch.equal(g[e], d)
    xc, xs, _ = HQ.hadamard_quest_quantize_experts(x)
    wc, ws, _ = HQ.hadamard_quest_quantize_experts(w.transpose(-1, -2))
    b, bs = wc.transpose(-1, -2), ws.transpose(-1, -2)
    y = MM.mxfp4_matmul_experts(xc, xs, b, bs)
    assert torch.equal(y, MM.mxfp4_matmul_experts_plain(xc, xs, b, bs))
    for e in range(x.shape[0]):
        assert torch.equal(y[e], MM.mxfp4_matmul(xc[e], xs[e], b[e], bs[e]))
