"""The reduced qwen3-moe train step at data-parallel width 2 against the
reference's one-device step under the bf16 method: the check of
``tests/test_torch_moe_dp_train_reference.py`` (each layer's selection bit
for bit; loss and grad-norm within rtol 1e-4, aux within rtol 1e-5; every
gradient within rtol 1e-4, atol 1e-5·max of the port's one-device step and
within rtol 1e-4, atol 1e-4·max|ref| of the reference's), in a file of its
own so that each file's ranks and jitted reference stay within a worker's
time budget.
"""

import pytest
from test_torch_moe_dp_train_reference import _one_thread, check_step  # noqa: F401

pytestmark = pytest.mark.sharded


def test_moe_dp2_bf16_step_equals_the_reference(tmp_path, monkeypatch):
    check_step(tmp_path, "bf16", monkeypatch)
