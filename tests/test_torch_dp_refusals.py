"""What data-parallel training does not do yet raises at more than one
data rank, each message naming its ROADMAP item, and nothing falls back to
one device silently: gradient compression and the baseline methods on
shards (A8d.2), the sequence-parallel fallback
(A8d.3), the SSM, hybrid, enc-dec and VLM families (A8d.4), tensor
parallelism (A8d.5); a data-parallel step without the parameters' specs;
the production mesh below 256 ranks.  The step raises before its first
collective, so a mesh of two ranks over no world stands in for one."""

import numpy as np
import pytest
import torch

import _dp_ranks as D
from repro_torch.configs import get_reduced_config
from repro_torch.distributed import context as C
from repro_torch.distributed import sharding as SH
from repro_torch.launch.mesh import Mesh, make_local_mesh, make_production_mesh
from repro_torch.models import build_model
from repro_torch.optim import adamw
from repro_torch.train.state import TrainState
from repro_torch.train.steps import make_eval_step, make_train_step

DP2 = Mesh(np.arange(2).reshape(2, 1), ("data", "model"))  # this process is data rank 0
TP2 = Mesh(np.arange(2).reshape(1, 2), ("data", "model"))
BATCH = {"tokens": torch.zeros((2, 16), dtype=torch.int32),
         "labels": torch.zeros((2, 16), dtype=torch.int32)}
EMPTY = TrainState({}, {"mu": {}}, 0)


def _step(arch="llama-paper-200m", mesh=DP2, state=EMPTY, **kw):
    model = build_model(D.tiny_cfg() if arch == "llama-paper-200m"
                        else get_reduced_config(arch))
    with C.activate_mesh(mesh):
        return make_train_step(model, adamw(1e-3), **kw)(state, BATCH)


@pytest.mark.parametrize("arch, item", [
    ("falcon-mamba-7b", "A8d.4"), ("zamba2-7b", "A8d.4"),
    ("whisper-tiny", "A8d.4"), ("llama-3.2-vision-11b", "A8d.4")])
def test_families_raise_at_dp2(arch, item):
    with pytest.raises(NotImplementedError, match=item):
        _step(arch)
    with pytest.raises(NotImplementedError, match=item):
        with C.activate_mesh(DP2):
            make_eval_step(build_model(get_reduced_config(arch)))({}, BATCH)


def test_optimizer_compression_and_baselines_raise_at_dp2():
    with pytest.raises(NotImplementedError, match="grad_compress.*A8d.2"):
        _step(grad_compress=True)
    with pytest.raises(NotImplementedError, match="luq_int4.*A8d.2"):
        _step(method="luq_int4")


def test_tensor_parallel_training_raises():
    with pytest.raises(NotImplementedError, match="A8d.5"):
        _step(mesh=TP2)
    with pytest.raises(NotImplementedError, match="A8d.5"):
        SH.sharded_dim(SH.P("data", "model"), TP2)


def test_sequence_parallel_fallback_raises():
    """Rows the data ranks do not divide: the reference would shard the
    sequence instead."""
    plan = C.make_plan(DP2, SH.param_partition({"w": torch.zeros((64, 64))}, DP2))
    plan.rows = 3
    with C.fsdp_plan(plan):
        with pytest.raises(NotImplementedError, match="A8d.3"):
            C.constrain_tokens(torch.zeros((1, 16, 8)))
    plan.rows = 4
    with C.fsdp_plan(plan):
        with pytest.raises(NotImplementedError, match="A8d.3"):  # not this rank's 2 rows
            C.constrain_tokens(torch.zeros((3, 16, 8)))
        x = torch.zeros((2, 16, 8))
        assert C.constrain_tokens(x) is x


def test_no_silent_one_device_step():
    with pytest.raises(ValueError, match="specs"):
        _step()
    with pytest.raises(ValueError, match="specs"):
        with C.activate_mesh(DP2):
            make_eval_step(build_model(D.tiny_cfg()))({}, BATCH)


def test_production_mesh_needs_its_ranks():
    with pytest.raises(ValueError, match="needs 256 ranks"):
        make_production_mesh()
    with pytest.raises(ValueError, match="needs 512 ranks"):
        make_production_mesh(multi_pod=True)
    mesh = make_local_mesh()  # one process: a world of one, every rank on data
    assert mesh.shape == {"data": 1, "model": 1}


def test_anchors_are_identities_outside_a_plan():
    """No plan (no mesh, or a serving mesh) leaves every input as it is."""
    tree = {"layers": {"attn": {"wq": {"w": torch.ones((2, 64, 64))}}}}
    with C.activate_mesh(DP2):
        assert C.constrain_params(tree) is tree
        assert C.constrain_layer_params(tree["layers"]) is tree["layers"]
        x = torch.zeros((3, 5, 7))
        assert C.constrain_tokens(x) is x and C.constrain_logits(x) is x
    assert C.token_window() == (0, 1)
