"""The port's sharding rules, meshes and replica placer against the
reference's.

``repro_torch.distributed.sharding`` is the reference's rule table as pure
functions over paths, shapes and the mesh's axis sizes.  On every
registered config — the port's own reduced param tree and, through
``jax.eval_shape``, the reference's full-size shapes — at the meshes
``{data: 16, model: 16}``, ``{pod: 2, data: 16, model: 16}`` and
``{data: 2, model: 2}``, its specs equal the reference's leaf for leaf, as
do ``opt_partition`` of the AdamW and 8-bit AdamW states,
``partition_state``, ``cache_partition``, ``batch_partition`` and
``serve_pool_partition``.  ``make_local_mesh``, ``make_serve_meshes``,
``ShardingConfig`` and ``Placement`` raise where the reference's raise (one
process here, one device there), and ``ReplicaPlacer`` makes the
reference's choices over a seeded inventory schedule.
"""

import functools

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from repro.configs import get_config as jget_config
from repro.configs import get_reduced_config as jget_reduced
from repro.configs.registry import ARCH_IDS
from repro.distributed import sharding as JS
from repro.launch import mesh as JM
from repro.models import build_model as jbuild
from repro.optim import adamw as jadamw
from repro.optim import adamw8bit as jadamw8bit
from repro.serve import placement as JPL
from repro.train.state import TrainState as JTrainState
from repro_torch.configs import get_reduced_config
from repro_torch.convert import init_params
from repro_torch.distributed import sharding as S
from repro_torch.launch import mesh as M
from repro_torch.optim import adamw, adamw8bit
from repro_torch.serve import placement as PL
from repro_torch.serve.paged_cache import PagedCache
from repro_torch.train.state import make_train_state


class FakeMesh:
    """axis_names/shape-only stand-in (the rules are arithmetic on sizes)."""

    def __init__(self, shape):
        self.shape = dict(shape)
        self.axis_names = tuple(shape)


MESHES = {"16x16": FakeMesh({"data": 16, "model": 16}),
          "2x16x16": FakeMesh({"pod": 2, "data": 16, "model": 16}),
          "2x2": FakeMesh({"data": 2, "model": 2})}


def _is_jp(x):
    return isinstance(x, JP)


def _ref_specs(tree) -> dict:
    """path → reference PartitionSpec."""
    flat = jax.tree_util.tree_flatten_with_path(tree, is_leaf=_is_jp)[0]
    return {"/".join(JS._key_name(k) for k in path): spec for path, spec in flat}


def _port_specs(tree) -> dict:
    """path → port PartitionSpec."""
    out = {}
    S.tree_map_with_path(lambda path, spec: out.__setitem__(path, spec), tree)
    return out


def _assert_same(port_tree, ref_tree):
    port, ref = _port_specs(port_tree), _ref_specs(ref_tree)
    assert set(port) == set(ref)
    bad = {p: (tuple(port[p]), ref[p]) for p in ref if JP(*port[p]) != ref[p]}
    assert not bad, bad
    assert all(isinstance(s, S.PartitionSpec) for s in port.values())


@functools.lru_cache(maxsize=None)
def _ref_shapes(arch: str, full: bool):
    cfg = jget_config(arch) if full else jget_reduced(arch)
    model = jbuild(cfg)
    return model, jax.eval_shape(model.init, jax.random.PRNGKey(0))


@functools.lru_cache(maxsize=None)
def _port_reduced(arch: str):
    cfg = get_reduced_config(arch)
    return init_params(cfg, torch.Generator().manual_seed(0), "cpu")


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_rules_on_the_reduced_trees(arch, mesh):
    """The port's own reduced param tree (torch tensors) against the
    reference's reduced tree: the same paths, the same specs."""
    m = MESHES[mesh]
    _assert_same(S.param_partition(_port_reduced(arch), m),
                 JS.param_partition(_ref_shapes(arch, False)[1], m))


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_rules_at_full_size(arch, mesh):
    m = MESHES[mesh]
    shapes = _ref_shapes(arch, True)[1]
    _assert_same(S.param_partition(shapes, m), JS.param_partition(shapes, m))
    _assert_same(S.param_partition(shapes, m, include_pod_fsdp=False),
                 JS.param_partition(shapes, m, include_pod_fsdp=False))


OPT_ARCHS = ["qwen3-moe-235b-a22b", "zamba2-7b", "llama-3.2-vision-11b", "falcon-mamba-7b"]
OPTS = {"adamw": (jadamw, adamw), "adamw8bit": (jadamw8bit, adamw8bit)}


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("opt", list(OPTS))
@pytest.mark.parametrize("arch", OPT_ARCHS)
def test_opt_partition_at_full_size(arch, opt, mesh):
    """Moments inherit their parameter's spec; the 8-bit moments' blocked
    leaves move the last dim's axis to the block count where it divides."""
    m = MESHES[mesh]
    shapes = _ref_shapes(arch, True)[1]
    state = jax.eval_shape(OPTS[opt][0](1e-3).init, shapes)
    ref = JS.opt_partition(state, JS.param_partition(shapes, m), m)
    got = S.opt_partition(state, S.param_partition(shapes, m), m)
    for key in ref:
        _assert_same(got[key], ref[key])


@pytest.mark.parametrize("opt", list(OPTS))
@pytest.mark.parametrize("arch", ["qwen3-moe-235b-a22b", "zamba2-7b"])
def test_partition_state_of_the_ports_own_state(arch, opt):
    """The port's TrainState (its own optimizer state, int step counter, no
    error feedback) gets the reference's specs for the reference's state."""
    m = MESHES["2x2"]
    tstate = make_train_state(_port_reduced(arch), OPTS[opt][1](1e-3))
    got = S.partition_state(tstate, S.param_partition(tstate.params, m), m)
    _, shapes = _ref_shapes(arch, False)
    jstate = JTrainState(shapes, jax.eval_shape(OPTS[opt][0](1e-3).init, shapes),
                         jax.ShapeDtypeStruct((), np.int32), None)
    ref = JS.partition_state(jstate, JS.param_partition(shapes, m), m)
    _assert_same(got.params, ref.params)
    for key in ref.opt_state:
        _assert_same(got.opt_state[key], ref.opt_state[key])
    assert got.step == () and got.err is None and ref.err is None


@pytest.mark.parametrize("mesh", list(MESHES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_cache_partition_at_full_size(arch, mesh):
    m = MESHES[mesh]
    model, _ = _ref_shapes(arch, True)
    for batch, max_len in ((128, 32768), (1, 524288), (8, 4096)):
        spec = model.cache_spec(batch, max_len)
        _assert_same(S.cache_partition(spec, m, batch), JS.cache_partition(spec, m, batch))


def test_batch_partition_grid():
    for m in MESHES.values():
        for batch in (1, 2, 3, 16, 32, 256, 512):
            for seq in (None, 7, 4096, 524288):
                assert JP(*S.batch_partition(m, batch, seq)) == JS.batch_partition(m, batch, seq)


@pytest.mark.parametrize("mesh", list(MESHES))
def test_serve_pool_partition(mesh):
    """The pool's head axis: sharded where the model axis divides the head
    count, replicated where it does not (the models read that as whole)."""
    m = MESHES[mesh]
    for heads in (1, 2, 4, 6, 8, 16, 32):
        pool = PagedCache(None, n_slots=1, pages_per_slot=1, page_size=4, device="cpu",
                          geometry=(2, heads, 64), dtype="bfloat16").pool
        want = JS.serve_pool_partition(
            {k: jax.ShapeDtypeStruct(tuple(v.shape), np.uint8) for k, v in pool.items()}, m)
        got = S.serve_pool_partition(pool, m)
        assert {k: JP(*v) for k, v in got.items()} == want


# the reference's own rule examples (tests/test_distributed.py)
EXAMPLES = [
    ("layers/attn/wq/w", (28, 2048, 2048)), ("layers/mlp/gate/w", (28, 2048, 6144)),
    ("layers/attn/wo/w", (28, 2048, 2048)), ("layers/mlp/down/w", (28, 6144, 2048)),
    ("layers/moe/gate", (94, 128, 4096, 1536)), ("layers/moe/down", (94, 128, 1536, 4096)),
    ("layers/moe/router/w", (94, 4096, 128)), ("embed/table", (151936, 2048)),
    ("lm_head/w", (2048, 151936)), ("layers/attn/wq/w", (30, 3072, 3072)),
    ("layers/attn/wq/w", (2, 100, 100)), ("layers/attn_norm/scale", (28, 2048)),
    ("layers/attn/wq/b", (30, 3072)), ("layers/conv_w", (64, 4, 8192)),
    ("layers/conv_b", (64, 8192)), ("layers/A_log", (64, 8192, 16)), ("layers/A_log", (112,)),
    ("layers/x_proj/w", (64, 8192, 288)), ("layers/dt_proj/w", (64, 256, 8192)),
]


@pytest.mark.parametrize("mesh", list(MESHES))
def test_rule_examples(mesh):
    m = MESHES[mesh]
    for inc in (True, False):
        for path, shape in EXAMPLES:
            got = S._spec_for(path, shape, m, S.fsdp_axes(m, inc))
            assert JP(*got) == JS._spec_for(path, shape, m, JS.fsdp_axes(m, inc)), path


def _raises_alike(port_fn, ref_fn, match: str):
    with pytest.raises(ValueError, match=match):
        ref_fn()
    with pytest.raises(ValueError, match=match):
        port_fn()


def test_meshes_and_configs_raise_like_the_reference():
    """One process here (a world of one), one device there."""
    assert M.world_size() == 1 and len(jax.devices()) == 1
    _raises_alike(lambda: M.make_local_mesh(model=2), lambda: JM.make_local_mesh(model=2),
                  "does not divide")
    _raises_alike(lambda: M.make_local_mesh(model=0), lambda: JM.make_local_mesh(model=0),
                  ">= 1")
    _raises_alike(lambda: M.make_serve_meshes(tp=0), lambda: JM.make_serve_meshes(tp=0),
                  ">= 1")
    _raises_alike(lambda: M.make_serve_meshes(dp=0), lambda: JM.make_serve_meshes(dp=0),
                  ">= 1")
    _raises_alike(lambda: M.make_serve_meshes(tp=2), lambda: JM.make_serve_meshes(tp=2),
                  "devices")
    _raises_alike(lambda: M.make_serve_meshes(tp=1, dp=3), lambda: JM.make_serve_meshes(1, 3),
                  "devices")
    _raises_alike(lambda: PL.ShardingConfig(tp=0), lambda: JPL.ShardingConfig(tp=0), "tp/dp")
    _raises_alike(lambda: PL.ShardingConfig(dp=0), lambda: JPL.ShardingConfig(dp=0), "tp/dp")
    _raises_alike(lambda: PL.Placement(tp=0), lambda: JPL.Placement(tp=0), "tp must")
    _raises_alike(lambda: PL.Placement(tp=2), lambda: JPL.Placement(tp=2), "devices")
    _raises_alike(lambda: PL.ReplicaPlacer(0), lambda: JPL.ReplicaPlacer(0), "n_replicas")
    mesh = M.make_local_mesh()
    assert mesh.shape == {"data": 1, "model": 1} and mesh.group("model") is None
    assert [m.shape for m in M.make_serve_meshes()] == [{"model": 1}]
    assert PL.Placement().tp == 1 and PL.Placement().mesh is None


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_replica_placer_makes_the_reference_choices(n):
    """Seeded inventories, each placement's replica losing a page and a slot
    afterwards (ties are frequent): the two placers choose alike."""
    rng = np.random.default_rng(n)
    port, ref = PL.ReplicaPlacer(n), JPL.ReplicaPlacer(n)
    pages = rng.integers(0, 6, n).tolist()
    slots = rng.integers(0, 3, n).tolist()
    for _ in range(300):
        got, want = port.place(pages, slots), ref.place(pages, slots)
        assert got == want
        pages[got] -= 1
        slots[got] -= 1
        if rng.random() < 0.3:  # a retirement somewhere returns capacity
            r = int(rng.integers(0, n))
            pages[r] += int(rng.integers(1, 4))
            slots[r] += 1


def test_replica_placer_reference_examples():
    p = PL.ReplicaPlacer(3)
    assert p.place([1, 9, 4], [1, 1, 1]) == 1
    assert p.place([4, 4, 9], [1, 1, 1]) == 2
    assert PL.ReplicaPlacer(2).place([5, 5], [1, 3]) == 1
    p3 = PL.ReplicaPlacer(3)
    assert [p3.place([2, 2, 2], [1, 1, 1]) for _ in range(3)] == [0, 1, 2]
