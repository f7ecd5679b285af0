"""The FP4 all-gather (``QuartetConfig.fp4_allgather``): the port's
``quest_qdq_gathered`` + ``quartet_linear_pq`` against the reference's on
the same numpy inputs.

Without a mesh: codes, scales and mask bit for bit (the reference's
E8M0-nearest rounds through ``log2``, which misrounds near √2·2^k, ROADMAP
C2; these inputs hit no such scale); y, dx and dW within 1e-5 (the SR
operands carry the reference's bits under ``use_reference_dot_order``).
``test_torch_dp_fp4_allgather_dp2.py`` holds the option at dp 2.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from test_torch_numerics import use_reference_dot_order

import repro.core.quartet as JQ
from repro.core import formats as JF
from repro.core import hadamard as JH
from repro.core import quantizers as JQu
from repro_torch.core.quartet import QuartetConfig, quartet_linear, quartet_linear_pq, \
    quest_qdq_gathered

pytestmark = pytest.mark.sharded


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel_l2(a, b) -> float:
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _operands(k=256, n=96, t=64):
    rng = np.random.default_rng(7)
    x = rng.standard_normal((2, t // 2, k)).astype(np.float32)
    w = (rng.standard_normal((k, n)) * 0.05).astype(np.float32)
    dy = rng.standard_normal((2, t // 2, n)).astype(np.float32)
    return x, w, dy


def test_quest_qdq_gathered_bit_exact_vs_reference():
    _, w, _ = _operands()
    jv, jm = JQ.quest_qdq_gathered(jnp.asarray(w), JQ.QuartetConfig(fp4_allgather=True))
    jq = JQu.quest(JH.hadamard_transform(jnp.asarray(w), g=32, axis=0).T, JF.MXFP4)
    for use_kernels in (False, True):
        vals, mask, codes, scales = quest_qdq_gathered(
            torch.from_numpy(w), QuartetConfig(use_kernels=use_kernels, fp4_allgather=True))
        np.testing.assert_array_equal(vals.numpy(), np.asarray(jv, np.float32))
        np.testing.assert_array_equal(mask.numpy(), np.asarray(jm))
        np.testing.assert_array_equal(codes.numpy(), np.asarray(jq.codes))
        np.testing.assert_array_equal(scales.numpy(), np.asarray(jq.scales))
        assert codes.dtype == torch.int8 and tuple(codes.shape) == (w.shape[1], w.shape[0])


@pytest.mark.parametrize("use_kernels", [False, True])
def test_quartet_linear_pq_vs_reference(use_kernels, monkeypatch):
    """y, dx and dW through both functions against ``jax.vjp`` of the
    reference's pair; and equal to the port's ``quartet_linear`` (the same
    arithmetic, the weight quantized in another place)."""
    use_reference_dot_order(monkeypatch)
    x, w, dy = _operands()
    jcfg = JQ.QuartetConfig(use_kernels=use_kernels, fp4_allgather=True)

    def jf(a, b):
        v, m = JQ.quest_qdq_gathered(b, jcfg)
        return JQ.quartet_linear_pq(a, v, m, jnp.uint32(5), jcfg)

    jy, vjp = jax.vjp(jax.jit(jf), jnp.asarray(x), jnp.asarray(w))
    jdx, jdw = vjp(jnp.asarray(dy))
    cfg = QuartetConfig(use_kernels=use_kernels, fp4_allgather=True)
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    vals, mask, codes, scales = quest_qdq_gathered(wt, cfg)
    y = quartet_linear_pq(xt, vals, mask, 5, cfg, codes, scales)
    dx, dw = torch.autograd.grad(y, (xt, wt), torch.from_numpy(dy))
    np.testing.assert_allclose(y.detach().numpy(), np.asarray(jy), rtol=0, atol=1e-5)
    for got, want in ((dx, jdx), (dw, jdw)):
        want = np.asarray(want, np.float32)
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5 * np.abs(want).max())
    ref = QuartetConfig(use_kernels=use_kernels)
    y2 = quartet_linear(xt, wt, 5, ref)
    dx2, dw2 = torch.autograd.grad(y2, (xt, wt), torch.from_numpy(dy))
    assert torch.equal(y.detach(), y2.detach()) and torch.equal(dx, dx2)
    assert _rel_l2(dw.numpy(), dw2.numpy()) < 1e-6

