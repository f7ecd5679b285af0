"""Helpers of the state and cross families' training tests
(``tests/test_torch_{ssm,hybrid,encdec,vlm}_train.py``): one reference init
carried into the port, a next-token loss and its gradients in both
packages, the reference's train steps against the port's from the
reference's state, and the tolerance checks.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jget_reduced
from repro.data import pipeline as JD
from repro.models import build_model as jbuild
from repro.optim import adamw as jadamw
from repro.optim import cosine_warmup as jcosine
from repro.train.state import make_train_state as jmake_train_state
from repro.train.steps import make_train_step as jmake_train_step
from repro_torch.checkpoint.checkpointer import _unflatten
from repro_torch.configs import get_reduced_config
from repro_torch.convert import _leaf, params_from_jax
from repro_torch.models import build_model
from repro_torch.optim import adamw, cosine_warmup
from repro_torch.train.state import make_train_state
from repro_torch.train.steps import _leaf_paths, make_train_step
from repro_torch.tree import tree_leaves, tree_unflatten

VOCAB = 512


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def pair(arch: str, key: int = 1, **over):
    """(reference model, its params, port model, the same params) of the
    reduced ``arch`` in f32, ``over`` replacing config fields in both."""
    jm = jbuild(dataclasses.replace(jget_reduced(arch, dtype="float32"), **over))
    jp = jax.device_get(jax.jit(jm.init)(jax.random.PRNGKey(key)))  # the eager init, compiled
    tcfg = dataclasses.replace(get_reduced_config(arch, dtype="float32"), **over)
    return jm, jp, build_model(tcfg), params_from_jax(jp, tcfg, "cpu")


def with_remat(model, remat: bool):
    return build_model(dataclasses.replace(model.cfg, remat=remat))


def set_gates(jp, tp, attn: float, mlp: float):
    """Every VLM cross block's gates set to (attn, mlp), in both trees."""
    n = tp["cross_layers"]["gate_attn"].shape[0]
    for name, g in (("gate_attn", attn), ("gate_mlp", mlp)):
        jp["cross_layers"][name] = np.full((n,), g, np.float32)
        tp["cross_layers"][name] = torch.full((n,), g, dtype=torch.float32)


_REF_GRADS = {}


def ref_loss_grads(jm, jp, tokens, labels, extra=None, method="bf16", seed=0):
    """The reference's mean next-token cross-entropy of ``model.forward``'s
    logits and its gradient (``jax.grad``), jitted once a config, method and
    seed: (loss, leaves in sorted-key order)."""
    key = (jm.cfg, method, seed)
    if key not in _REF_GRADS:
        def loss(p, tokens, labels, extra):
            logits = jm.forward(p, tokens, jnp.uint32(seed), extra=extra, method=method)[0]
            lp = jax.nn.log_softmax(logits.astype(jnp.float32), -1)
            return -jnp.mean(jnp.take_along_axis(lp, labels[..., None], -1))

        _REF_GRADS[key] = jax.jit(jax.value_and_grad(loss))
    value, grads = _REF_GRADS[key](jp, tokens, labels, extra)
    return float(value), jax.tree.leaves(grads)


def ref_block_vjp(block, layer, x, dy):
    """``block(layer, x)`` of the reference and its vjp at ``dy``, in one
    jitted call: (y, layer's gradient leaves, dx)."""
    def run(p, xx, d):
        y, vjp = jax.vjp(block, p, xx)
        return (y, *vjp(d))

    y, gp, gx = jax.jit(run)(layer, jnp.asarray(x), jnp.asarray(dy))
    return y, jax.tree.leaves(gp), gx


def port_loss_grads(tm, tp, tokens, labels, extra=None, method="bf16", seed=0):
    """The port's loss and gradient (autograd) as :func:`ref_loss_grads`;
    a leaf the loss does not reach has a zero gradient."""
    leaves = [t.clone().requires_grad_() for t in tree_leaves(tp)]
    logits, _ = tm.forward(tree_unflatten(tp, leaves), torch.from_numpy(tokens), seed,
                           extra=extra, method=method)
    lp = torch.log_softmax(logits.float(), -1)
    loss = -lp.gather(-1, torch.from_numpy(labels).long()[..., None]).mean()
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    return float(loss.detach()), [torch.zeros_like(t) if g is None else g
                                  for g, t in zip(grads, leaves)]


def close(got, want, rtol, atol_frac, name=""):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (name, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=rtol, atol=atol_frac * np.abs(want).max(),
                               err_msg=name)


def _key_bias(path) -> bool:
    """An attention's key bias: softmax over the keys is invariant to it, so
    its gradient is 0 up to rounding noise in both packages."""
    return tuple(path[-2:]) == ("wk", "b")


def grads_close(tp, got, want, rtol=1e-4, atol_frac=1e-4, flipped_columns=0):
    """Every leaf's gradient within rtol and atol_frac·max|ref| of the
    reference's, by its path; with ``flipped_columns`` a 2-d weight's
    gradient may have that many columns outside, each element of them within
    1% of max|ref|: a stochastic-rounding decision of the dW stage flipped
    by an upstream rounding difference moves one column by a grid step
    (ROADMAP C4).  A key bias's gradient (rounding noise) is held within
    1e-6 of the largest gradient of any leaf instead."""
    paths = _leaf_paths(tp)
    assert len(paths) == len(got) == len(want)
    top = max(float(np.abs(np.asarray(jg)).max()) for jg in want)
    for path, g, jg in zip(paths, got, want):
        name = ".".join(path)
        g, jg = g.detach().float().numpy(), np.asarray(jg, np.float32)
        if _key_bias(path):
            assert max(np.abs(g).max(), np.abs(jg).max()) <= 1e-6 * top, name
            continue
        if flipped_columns and g.ndim == 2:
            scale = np.abs(jg).max()
            bad = np.abs(g - jg) > rtol * np.abs(jg) + atol_frac * scale
            cols = np.flatnonzero(bad.any(0))
            assert len(cols) <= flipped_columns, (name, cols)
            assert np.abs(g - jg)[:, cols].max(initial=0) <= 1e-2 * scale, name
            g, jg = np.delete(g, cols, 1), np.delete(jg, cols, 1)
        close(g, jg, rtol, atol_frac, name)


def tokens_labels(batch: int, seq: int, seed: int):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, VOCAB, (batch, seq + 1)).astype(np.int32)
    return t[:, :-1], t[:, 1:]


def _close_but(got, want, rtol, atol_frac, flipped):
    """Within rtol and atol_frac·max|want| at all but a ``flipped`` share of
    the elements (at least one)."""
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    tol = atol_frac * np.abs(want).max() + rtol * np.abs(want)
    bad = np.abs(got - want) > tol
    assert bad.sum() <= np.ceil(flipped * bad.size), (float(np.abs(got - want).max()),
                                                      int(bad.sum()))


def _port_state(jstate, like):
    """The reference's TrainState as the port's, leaf by leaf in the
    checkpoint order (the step counters as Python ints)."""
    leaves = [_leaf(a, "cpu") if np.ndim(a) else int(a) for a in jax.tree.leaves(jstate)]
    return _unflatten(like, iter(leaves))


def train_steps_match(jm, jp, tm, tp, extra=None, steps=2, microbatch=1, batch=4, seq=16,
                      method="bf16"):
    """``steps`` train steps (AdamW, cosine warmup, clip 1.0) of the
    reference's jitted ``make_train_step`` and the port's on the same
    batches (``extra``: numpy conditioning joining every batch), each step
    starting the port from the reference's state: loss, nll and grad-norm
    within rtol 1e-4; every parameter and moment within rtol 1e-4 and
    1e-4·max|ref|, but for 1 in 10^4 elements of a leaf (at least one):
    AdamW's first updates follow each gradient element's sign, and an
    element within rounding of 0 can take the other sign (the two libraries
    sum norms, attention and the scans in other orders).  A key bias is not
    compared: its gradient is rounding noise, which AdamW turns into an
    update of any sign."""
    jopt, topt = jadamw(jcosine(1e-3, 10)), adamw(cosine_warmup(1e-3, 10))
    jstep = jax.jit(jmake_train_step(jm, jopt, method=method, microbatch=microbatch))
    jstate = jax.jit(lambda p: jmake_train_state(p, jopt))(jp)
    step = make_train_step(tm, topt, method=method, microbatch=microbatch)
    state = make_train_state(tp, topt)
    batcher = JD.TokenBatcher(JD.SyntheticC4Dataset(VOCAB, seed=0), batch, seq)
    for i in range(steps):
        b = {**batcher.batch(i), **(extra or {})}
        state = _port_state(jstate, state)
        jstate, jmet = jstep(jstate, {k: jnp.asarray(v) for k, v in b.items()})
        state, met = step(state, {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()})
        for key in ("loss", "nll", "grad_norm"):
            close(float(met[key]), float(jmet[key]), 1e-4, 0.0, key)
        assert state.step == i + 1 and int(jstate.step) == i + 1
        moments = {"mu": state.opt_state["mu"], "nu": state.opt_state["nu"]}
        jmoments = {"mu": jstate.opt_state["mu"], "nu": jstate.opt_state["nu"]}
        for got, want in ((state.params, jstate.params), (moments, jmoments)):
            for path, p, jp_ in zip(_leaf_paths(got), tree_leaves(got), jax.tree.leaves(want)):
                if not _key_bias(path):  # its noise gradient turns into any update
                    _close_but(p.float().numpy(), jp_, 1e-4, 1e-4, 1e-4)
    return state, met
