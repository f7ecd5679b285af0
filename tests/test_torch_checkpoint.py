"""PyTorch port vs the JAX reference: checkpoint and resume of training.

* Resume is bit-exact: a run killed after 3 of 6 steps and started again
  from its checkpoint ends with the unbroken run's params, optimizer state
  and step, and its losses from step 3 on (the twin of
  ``tests/test_train_integration.py::test_resume_is_bit_exact``, at half
  its 12 steps to keep the CPU suite short).
* Restore onto an explicit device keeps each leaf's saved dtype (f32 or
  bf16 master) and the Python-int step counters; a checkpoint of another
  structure raises (twins of ``tests/test_elastic.py``).
* The last K checkpoints are kept and orphaned ``.tmp`` directories go.
* The on-disk layout is the reference's: a checkpoint the reference's
  ``Checkpointer`` wrote restores in the port, params equal to
  ``params_from_jax`` of the same tree, and the reverse.
* ``launch/train.py --checkpoint-dir`` resumes.
"""

import os
import sys

import jax
import numpy as np
import pytest
import torch

from repro.checkpoint import Checkpointer as JCheckpointer
from repro.configs.llama_paper import tiny_llama as jtiny_llama
from repro.models import build_model as jbuild
from repro.optim import adamw as jadamw
from repro.train.state import make_train_state as jmake_train_state
from repro_torch.checkpoint import Checkpointer
from repro_torch.configs.llama_paper import tiny_llama
from repro_torch.convert import init_params, params_from_jax
from repro_torch.data.pipeline import SyntheticC4Dataset, TokenBatcher
from repro_torch.models import build_model
from repro_torch.optim import adamw, cosine_warmup
from repro_torch.train.loop import train
from repro_torch.train.state import make_train_state
from repro_torch.tree import tree_leaves, tree_map


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """One intra-op thread: these tests run many small ops, which several
    threads a worker only slow down when the suite runs on several workers."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(d=64, layers=2, vocab=256):
    cfg = tiny_llama(d=d, layers=layers, vocab=vocab)
    batcher = TokenBatcher(SyntheticC4Dataset(vocab_size=vocab, seed=1), global_batch=8,
                           seq_len=64)
    return cfg, build_model(cfg), batcher


def _state(cfg, master_dtype="float32"):
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    return make_train_state(params, adamw(1e-3), master_dtype)


def _assert_states_equal(a, b):
    for x, y in zip(tree_leaves(a.params) + tree_leaves(a.opt_state),
                    tree_leaves(b.params) + tree_leaves(b.opt_state)):
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and torch.equal(x, y)
        else:
            assert type(x) is int and type(y) is int and x == y
    assert a.step == b.step


def test_resume_is_bit_exact(tmp_path):
    cfg, model, batcher = _setup()
    opt = adamw(cosine_warmup(1e-3, 20), weight_decay=0.0)
    sA, hA = train(model, opt, batcher, 6, log_every=0, checkpoint_dir=str(tmp_path / "a"),
                   checkpoint_every=3, device="cpu")
    # the second run is killed at step 3 (a fresh call resumes from its checkpoint)
    train(model, opt, batcher, 3, log_every=0, checkpoint_dir=str(tmp_path / "b"),
          checkpoint_every=3, device="cpu")
    logs = []
    sB, hB = train(model, opt, batcher, 6, log_every=0, checkpoint_dir=str(tmp_path / "b"),
                   checkpoint_every=3, device="cpu", log_fn=logs.append)
    assert logs == [f"[resume] restored step 3 from {tmp_path / 'b'}"]
    _assert_states_equal(sA, sB)
    assert sB.step == sB.opt_state["step"] == 6
    assert [h["step"] for h in hB] == list(range(3, 6))
    for a, b in zip(hA[3:], hB):
        assert a["loss"] == b["loss"] and a["grad_norm"] == b["grad_norm"]
    assert Checkpointer(str(tmp_path / "b")).all_steps() == [3, 6]


@pytest.mark.parametrize("master_dtype", ["float32", "bfloat16"])
def test_restore_with_explicit_device_and_dtype(tmp_path, master_dtype):
    cfg, _, _ = _setup()
    state = _state(cfg, master_dtype)
    state = state._replace(step=3, opt_state={**state.opt_state, "step": 3})
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(3, state, blocking=True)
    like = _state(cfg, "float32")._replace(step=0)
    like = like._replace(params=tree_map(torch.zeros_like, like.params))
    restored, meta = ckpt.restore(like, device=torch.device("cpu"))
    assert meta["step"] == 3
    assert meta["dtypes"][0] == master_dtype
    _assert_states_equal(state, restored)  # the saved dtype, not the like-state's


def test_restore_detects_structure_mismatch(tmp_path):
    cfg, _, _ = _setup()
    ckpt = Checkpointer(str(tmp_path))
    ckpt.save(1, _state(cfg), blocking=True)
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(_state(cfg).params)  # params alone: fewer leaves
    for other in (tiny_llama(d=64, layers=3, vocab=256), tiny_llama(d=64, layers=2, vocab=512)):
        with pytest.raises(ValueError, match="shape"):
            ckpt.restore(_state(other))
    with pytest.raises(FileNotFoundError):
        Checkpointer(str(tmp_path / "empty")).restore(_state(cfg))


def test_keep_last_k_and_remove_orphaned_tmp(tmp_path):
    cfg, _, _ = _setup()
    state = _state(cfg)
    ckpt = Checkpointer(str(tmp_path), keep=2)
    os.makedirs(tmp_path / "step_000000009.tmp")  # a writer that died
    for s in (1, 2, 3, 4):
        ckpt.save(s, state._replace(step=s))  # on the background thread
    ckpt.wait()
    assert sorted(os.listdir(tmp_path)) == ["step_000000003", "step_000000004"]
    assert ckpt.latest_step() == 4
    restored, meta = ckpt.restore(state, step=3)
    assert meta["step"] == 3 and restored.step == 3
    assert sorted(os.listdir(tmp_path / "step_000000003")) == sorted(
        [f"{i}.npy" for i in range(meta["num_leaves"])] + ["meta.json"])


def _jax_state(layers=2, master_dtype="float32"):
    jcfg = jtiny_llama(d=64, layers=layers, vocab=256)
    jp = jbuild(jcfg).init(jax.random.PRNGKey(0))
    return jcfg, jmake_train_state(jp, jadamw(1e-3), master_dtype)


@pytest.mark.parametrize("master_dtype", ["float32", "bfloat16"])
def test_reference_checkpoint_restores_in_port_and_back(tmp_path, master_dtype):
    """Same layout both ways: the reference's whole TrainState restores into
    the port's (params equal to ``params_from_jax`` of the same tree, steps
    as ints), and the port's params restore in the reference."""
    _, jstate = _jax_state(master_dtype=master_dtype)
    JCheckpointer(str(tmp_path / "ref")).save(5, jstate, blocking=True)
    cfg = tiny_llama(d=64, layers=2, vocab=256)
    like = _state(cfg, master_dtype)
    restored, meta = Checkpointer(str(tmp_path / "ref")).restore(like)
    assert meta["step"] == 5
    want = params_from_jax(jax.device_get(jstate.params), cfg, "cpu")
    for a, b in zip(tree_leaves(restored.params), tree_leaves(want)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert restored.step == 0 and restored.opt_state["step"] == 0
    assert all(not bool(t.any()) for t in tree_leaves(restored.opt_state["mu"]))

    Checkpointer(str(tmp_path / "port")).save(7, want, blocking=True)
    back, jmeta = JCheckpointer(str(tmp_path / "port")).restore(jstate.params)
    assert jmeta["step"] == 7
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(jstate.params)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def _launch(monkeypatch, capsys, *extra):
    from repro_torch.launch import train as launcher

    monkeypatch.setattr(sys, "argv", ["train", "--reduced", "--device", "cpu", "--batch", "2",
                                      "--seq", "32", *extra])
    launcher.main()
    return capsys.readouterr().out


def test_launcher_checkpoint_dir_resumes(tmp_path, monkeypatch, capsys):
    """The same command started again after a kill: a 4-step run checkpoints
    at steps 2 and 4; with step 4's directory removed (the run died before
    writing it) the command resumes at step 2 and retraces steps 2 and 3."""
    import shutil

    def losses(out):
        return {ln.split()[1]: ln.split()[3] for ln in out.splitlines()
                if ln.startswith("step ")}

    cmd = ["--steps", "4", "--checkpoint-dir", str(tmp_path), "--checkpoint-every", "2"]
    whole = losses(_launch(monkeypatch, capsys, *cmd))
    assert Checkpointer(str(tmp_path)).all_steps() == [2, 4]
    shutil.rmtree(tmp_path / "step_000000004")
    out = _launch(monkeypatch, capsys, *cmd)
    assert "[resume] restored step 2" in out and "steps 2..3" in out
    assert losses(out) == {k: v for k, v in whole.items() if int(k) >= 2}
    assert Checkpointer(str(tmp_path)).all_steps() == [2, 4]
    assert "nothing to run" in _launch(monkeypatch, capsys, *cmd)
