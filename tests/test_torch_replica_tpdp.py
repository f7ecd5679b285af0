"""Data-parallel serving of the port on the CPU: ``ReplicatedEngine`` at
tp 2 x dp 2 (four ranks) over gloo ranks against one device.

Twin of the reference's replica tests (dp 2 in ``tests/test_torch_replica.py``): reduced
qwen3-1.7b's workload with self-speculation and the prefix cache; every
request's tokens equal the one-device engine's bit for bit.  Request ids
are unique and ``completed`` comes in submission order on every rank; the
placer spreads the work, so both replicas serve; the merged telemetry
sums the counters and pools the histograms of both replicas (the
profiler's one trace with a lane per replica: the dp 2 file).
"""

import pytest
import torch

import _tp_ranks as R

pytestmark = pytest.mark.sharded

TP, DP = 2, 2


@pytest.fixture(scope="module", autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    return R.replica_runs(tmp_path_factory, "qwen3-1.7b", TP, DP, profile=False)


def test_replicas_token_exact(runs):
    R.assert_replicas_token_exact(runs)


def test_rids_unique_in_submission_order_and_both_replicas_serve(runs):
    R.assert_rids_and_replicas(runs, TP)


def test_aggregate_sums_counters_and_pools_histograms(runs):
    R.assert_aggregate_pools(runs, TP)
