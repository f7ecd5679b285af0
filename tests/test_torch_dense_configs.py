"""The remaining dense configs (A6c) and the training example's twin.

The four configs of this slice field for field against the reference's,
with equal ``n_params``; reduced starcoder2-3b (the GELU MLP with biases)
scored by both packages from one reference init (carried over by
``params_from_jax``; its train step: ``tests/test_torch_dense_train.py``);
and ``examples.train_c4 --tiny --device cpu`` resuming bit for bit.

Tolerances.  Logits: 2e-5 (f32; under ``bf16`` only summation orders
differ, under ``quartet`` the port's plain path rounds as the reference's
does, ``tests/test_torch_model.py``).  The GELU is the tanh form on both
(``jax.nn.gelu``'s default); its f32 ``tanh`` rounds per library.
"""

import dataclasses
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as jget_config
from repro.configs import get_reduced_config as jget_reduced
from repro.models import build_model as jbuild
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import get_config, get_reduced_config
from repro_torch.convert import params_from_jax
from repro_torch.examples import train_c4
from repro_torch.models import build_model

NEW_ARCHS = ["deepseek-7b", "starcoder2-3b", "internlm2-20b", "falcon-mamba-7b"]
TOKENS = np.random.default_rng(2).integers(0, 512, (2, 24)).astype(np.int32)


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("arch", NEW_ARCHS)
def test_configs_match_reference(arch):
    for cfg, jcfg in ((get_config(arch), jget_config(arch)),
                      (get_reduced_config(arch), jget_reduced(arch))):
        for f in dataclasses.fields(cfg):
            if f.name == "quartet":
                for q in dataclasses.fields(cfg.quartet):
                    if hasattr(jcfg.quartet, q.name):
                        assert getattr(cfg.quartet, q.name) == getattr(jcfg.quartet, q.name)
                continue
            assert getattr(cfg, f.name) == getattr(jcfg, f.name), (arch, f.name)
        assert cfg.n_params() == jcfg.n_params()
        assert cfg.n_params(non_embedding=False) == jcfg.n_params(non_embedding=False)


def starcoder_pair_of():
    """Reduced starcoder2-3b (f32) from one reference init, in both
    packages, its biases drawn nonzero."""
    jcfg = jget_reduced("starcoder2-3b", dtype="float32")
    jm = jbuild(jcfg)
    jp = jm.init(jax.random.PRNGKey(0))
    # nonzero biases, so that the test sees them (the init draws zeros)
    leaves, tdef = jax.tree.flatten_with_path(jp)
    rng = np.random.default_rng(4)
    leaves = [0.1 * jnp.asarray(rng.standard_normal(v.shape), v.dtype)
              if str(path[-1]) == "['b']" else v for path, v in leaves]
    jp = jax.tree.unflatten(tdef, leaves)
    tcfg = get_reduced_config("starcoder2-3b", dtype="float32")
    return jm, jp, build_model(tcfg), params_from_jax(jax.device_get(jp), tcfg, "cpu")


@pytest.fixture(scope="module")
def starcoder_pair():
    return starcoder_pair_of()


@pytest.mark.parametrize("method", ["bf16", "quartet"])
def test_starcoder2_logits_match_reference(starcoder_pair, method):
    jm, jp, tm, tp = starcoder_pair
    assert set(tp["layers"]["mlp"]) == {"up", "down"} and "b" in tp["layers"]["mlp"]["up"]
    assert float(tp["layers"]["mlp"]["up"]["b"].abs().max()) > 0
    want = np.asarray(jax.jit(lambda p, t: jm.forward(p, t, jnp.uint32(0), method=method)[0])(
        jp, jnp.asarray(TOKENS)))
    with torch.no_grad():
        got, _ = tm.forward(tp, torch.from_numpy(TOKENS), 0, method=method)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=2e-5)


def test_train_c4_tiny_resumes_bit_identically(tmp_path, capsys):
    """2 steps unbroken against 1 step, a restart from its checkpoint, and
    the second step: equal final checkpoints, leaf for leaf."""
    args = ["--tiny", "--device", "cpu", "--steps", "2", "--batch", "2", "--seq", "32",
            "--checkpoint-every", "1"]
    whole, part = tmp_path / "whole", tmp_path / "part"
    s_whole, hist, val = train_c4.main(args + ["--checkpoint-dir", str(whole)])
    assert [h["step"] for h in hist] == [0, 1] and np.isfinite(val)
    train_c4.main(args + ["--checkpoint-dir", str(part)])
    ck = Checkpointer(str(part))
    assert ck.latest_step() == 2
    shutil.rmtree(part / "step_000000002")  # as if killed after step 1's checkpoint
    assert ck.latest_step() == 1
    s_part, hist2, _ = train_c4.main(args + ["--checkpoint-dir", str(part)])
    assert [h["step"] for h in hist2] == [1]
    assert "[resume] restored step 1" in capsys.readouterr().out
    assert s_part.step == s_whole.step == 2
    assert _equal(s_whole.params, s_part.params) and _equal(s_whole.opt_state, s_part.opt_state)


def _equal(a, b) -> bool:
    """Trees of dicts, sequences, tensors and numbers equal leaf for leaf."""
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(_equal(a[k], b[k]) for k in a)
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(_equal(x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return torch.equal(a, b)
    return a == b
