"""A train step under a one-rank training mesh (``make_local_mesh()`` in a
world of one, as ``launch.train`` runs a single process) goes through the
anchors and equals the step without a mesh bit for bit, in f32 and in
bf16, with fp4_allgather off and on.  At one rank the anchors hand every
leaf over in its own dtype: only a plan across data ranks widens leaves to
f32 (``distributed.context.widened``).  The LM head's product alone takes
the blocked dx of ``models.layers.head_product``; any other bf16 dense is
one product."""

import numpy as np
import pytest
import torch

import _dp_ranks as D
from repro_torch.convert import init_params
from repro_torch.core.quartet import QuartetConfig
from repro_torch.data import pipeline as TD
from repro_torch.distributed import context as C
from repro_torch.distributed import sharding as SH
from repro_torch.launch.mesh import Mesh, make_local_mesh
from repro_torch.models import layers as L

pytestmark = pytest.mark.sharded


@pytest.mark.parametrize("dtype, fp4", [("float32", False), ("bfloat16", False),
                                        ("bfloat16", True)])
def test_one_rank_mesh_equals_no_mesh(dtype, fp4):
    params = init_params(D.tiny_cfg(dtype), torch.Generator().manual_seed(1), "cpu")
    batch = TD.TokenBatcher(TD.SyntheticC4Dataset(D.VOCAB, seed=1), D.BATCH, D.SEQ).batch(0)
    loss1, gn1, g1, _, n1 = D.step_grads(params, batch, dtype=dtype, fp4=fp4)
    with C.activate_mesh(make_local_mesh()):
        loss, gn, g, dims, n = D.step_grads(params, batch, dtype=dtype, fp4=fp4)
    assert dims and loss == loss1 and gn == gn1 and n == n1
    assert set(g) == set(g1)
    for p in g1:
        np.testing.assert_array_equal(g[p], g1[p], err_msg=p)


def test_one_rank_anchors_keep_each_leaf_dtype():
    mesh = make_local_mesh()
    tree = {"layers": {"attn": {"wq": {"w": torch.ones((2, 64, 64), dtype=torch.bfloat16)}},
                       "attn_norm": {"scale": torch.ones((2, 64), dtype=torch.bfloat16)}}}
    plan = C.make_plan(mesh, SH.param_partition(tree, mesh))
    layer = {"attn": {"wq": {"w": tree["layers"]["attn"]["wq"]["w"][0]}},
             "attn_norm": {"scale": tree["layers"]["attn_norm"]["scale"][0]}}
    with C.fsdp_plan(plan), torch.enable_grad():
        assert not C.widened()
        out = C.constrain_layer_params(layer)
        assert out["attn"]["wq"]["w"].dtype == torch.bfloat16
        assert out["attn_norm"]["scale"].dtype == torch.bfloat16
        w = torch.ones((4, 4), dtype=torch.float32)
        assert C.weight_operand(w, torch.bfloat16).dtype == torch.bfloat16


def test_a_plan_across_ranks_widens_under_autograd_only():
    dp2 = Mesh(np.arange(2).reshape(2, 1), ("data", "model"))  # this process is rank 0
    plan = C.make_plan(dp2, {"w": SH.P(None, None)})
    w = torch.ones((4, 4), dtype=torch.float32)
    assert not C.widened()
    with C.fsdp_plan(plan):
        with torch.enable_grad():
            assert C.widened()
            assert C.weight_operand(w, torch.bfloat16) is w
        with torch.no_grad():
            assert not C.widened()
            assert C.weight_operand(w, torch.bfloat16).dtype == torch.bfloat16


@pytest.mark.parametrize("head", [False, True])
def test_only_the_head_takes_the_blocked_dx(head):
    gen = torch.Generator().manual_seed(2)
    x = torch.randn((3, 8, 48), generator=gen).to(torch.bfloat16).requires_grad_()
    w = (torch.randn((48, 40), generator=gen) / 7).to(torch.bfloat16).requires_grad_()
    y = L.dense({"w": w}, x, 0, QuartetConfig(), method="bf16", head=head)
    assert ("_HeadProduct" in type(y.grad_fn.next_functions[0][0]).__name__) == head
    g = torch.randn(y.shape, generator=gen).to(torch.bfloat16)
    dx, dw = torch.autograd.grad(y, (x, w), g)
    xf, wf, gf = x.detach().double(), w.detach().double(), g.double()
    np.testing.assert_allclose(y.detach().double(), (xf @ wf).to(torch.bfloat16).double(),
                               rtol=1e-2, atol=1e-2)
    np.testing.assert_allclose(dx.double(), gf @ wf.t(), rtol=2e-2, atol=2e-2)
    np.testing.assert_allclose(dw.double(), xf.reshape(-1, 48).t() @ gf.reshape(-1, 40),
                               rtol=2e-2, atol=5e-2)
