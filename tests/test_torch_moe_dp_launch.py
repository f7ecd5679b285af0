"""``launch/train.py --arch qwen3-moe-235b-a22b --reduced --opt8bit`` over
two gloo ranks (``--device cpu``), each process started with the
environment ``torchrun`` gives it (``RANK``, ``WORLD_SIZE``,
``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``): MoE Quartet training
with the 8-bit AdamW and a bf16 master at data-parallel width 2, a
checkpoint after step 0; the same command with more steps resumes there."""

import os
import socket
import subprocess
import sys

import pytest

pytestmark = pytest.mark.sharded

SRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "src")


def _launch(ckpt: str, steps: int) -> str:
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", "qwen3-moe-235b-a22b",
           "--reduced", "--opt8bit", "--device", "cpu", "--steps", str(steps), "--batch", "4",
           "--seq", "32", "--checkpoint-dir", ckpt, "--checkpoint-every", "1"]
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                              env=dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1",
                                       RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE="2",
                                       MASTER_ADDR="localhost", MASTER_PORT=str(port)))
             for r in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=120))
    finally:
        for p in procs:
            p.kill()
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, out[-2000:] + err[-4000:]
    return outs[0][0]


def test_launcher_trains_moe_8bit_at_dp2_and_resumes(tmp_path):
    ckpt = str(tmp_path / "ckpt")
    first = _launch(ckpt, 1)
    assert "step      0 loss" in first and "on 2 x cpu (data parallel)" in first, first
    assert os.path.isdir(os.path.join(ckpt, "step_000000001"))
    second = _launch(ckpt, 2)
    assert "[resume] restored step 1" in second and "step      1 loss" in second, second
    assert "step      0 loss" not in second
