"""The FP4 all-gather on a MoE layer's stacked experts (no JAX): the
stacks [E, K, N] rotated and QuEST-quantized on a rank's shard (K for
``gate`` and ``up``, N for ``down``), their codes and scales all-gathered,
then a block of experts taken (``core.quartet.quest_qdq_gathered`` and
``quartet_linear_pq`` with an expert axis).

* One device, and a world of one through the anchors: the reduced qwen3-moe
  Quartet step with ``fp4_allgather`` on equals the step with it off, and
  the step without a mesh, bit for bit (loss, grad-norm, aux, every
  gradient); ``moe_ffn`` on = off too, forward and backward.
* dp 2 (two gloo ranks, the shared-group layout): on and off give the same
  loss and aux bit for bit (the gathered codes are the whole stacks'), and
  gradients within rtol 1e-4, atol 1e-5·max a leaf (on reduce-scatters
  dW_rot in the rotated space, before the mask and H⁻¹; off after them).
"""

import numpy as np
import pytest
import torch

import _moe_dp_ranks as M
from repro_torch.convert import init_params
from repro_torch.data.pipeline import SyntheticC4Dataset, TokenBatcher
from repro_torch.distributed.context import activate_mesh
from repro_torch.launch.mesh import make_local_mesh
from repro_torch.models import moe as TM
from repro_torch.tree import tree_leaves, tree_unflatten

pytestmark = pytest.mark.sharded


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs():
    cfg = M.moe_cfg()
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    batch = TokenBatcher(SyntheticC4Dataset(cfg.vocab_size, seed=5), 4, M.SEQ).batch(0)
    return params, batch


def test_fp4_allgather_on_equals_off_on_one_rank():
    params, batch = _inputs()
    runs = {"off": M.moe_step(params, batch), "on": M.moe_step(params, batch, fp4=True)}
    with activate_mesh(make_local_mesh()):  # a world of one, through the anchors
        runs["mesh_on"] = M.moe_step(params, batch, fp4=True)
    base = runs["off"]
    for name, r in runs.items():
        assert r[:3] == base[:3], (name, r[:3], base[:3])
        for p, g in base[3].items():
            np.testing.assert_array_equal(r[3][p], g, err_msg=f"{name} {p}")
    # the layer alone, forward and backward
    layer = {k: v[0] for k, v in params["layers"]["moe"].items() if k != "router"}
    layer["router"] = {"w": params["layers"]["moe"]["router"]["w"][0]}
    x = torch.randn((2, M.SEQ, 128), generator=torch.Generator().manual_seed(1))
    out = []
    for fp4 in (False, True):
        leaves = [t.clone().requires_grad_() for t in tree_leaves(layer)]
        xt = x.clone().requires_grad_()
        y, aux = TM.moe_ffn(tree_unflatten(layer, leaves), xt, 11, M.moe_cfg(fp4=fp4))
        out.append((y.detach(), aux.detach(), *torch.autograd.grad(y.square().sum() + aux,
                                                                   [xt, *leaves])))
    for a, b in zip(*out):
        assert torch.equal(a, b)


def test_fp4_allgather_at_dp2_is_within_tolerance_of_off(tmp_path):
    params, batch = _inputs()
    ranks = M.start(tmp_path, 2, "moe_step_ranks", params, batch,
                    [{"fp4": False}, {"fp4": True}])
    for off, on in ranks.join():
        assert on[0] == off[0] and on[2] == off[2]  # loss, aux
        np.testing.assert_allclose(on[1], off[1], rtol=1e-5)
        for p, w in off[3].items():
            np.testing.assert_allclose(on[3][p], w, rtol=1e-4, atol=1e-5 * np.abs(w).max(),
                                       err_msg=p)
        assert on[6].keys() == off[6].keys()
        for s, (first, sel) in off[6].items():
            assert on[6][s][0] == first and np.array_equal(on[6][s][1], sel)


def test_expert_stacks_gather_as_codes_at_dp2():
    """The anchors tag the expert stacks for the FP4 all-gather with their
    shard dim (K for gate and up, N for down) and gather the other leaves
    whole."""
    from repro_torch.distributed import context as C
    from repro_torch.distributed import sharding as SH
    from repro_torch.launch.mesh import Mesh

    params, _ = _inputs()
    mesh = Mesh(np.arange(2).reshape(2, 1), ("data", "model"))  # no world: no collective
    plan = C.make_plan(mesh, SH.param_partition(params, mesh), fp4_allgather=True)
    shards = SH.shard_tree(params, SH.param_partition(params, mesh), mesh)
    layer = {k: v[0] for k, v in shards["layers"]["moe"].items() if k != "router"}
    with C.fsdp_plan(plan):
        tagged = C._anchor({"moe": layer}, "layers", plan, stacked=True)["moe"]
    assert {k: C.fsdp_dim(tagged[k]) for k in ("gate", "up", "down")} == {
        "gate": 1, "up": 1, "down": 2}
    assert tagged["gate"].shape == (8, 64, 64) and tagged["down"].shape == (8, 64, 64)
