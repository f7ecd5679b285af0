"""rmsnorm's one summation order on every device.

``models.layers.rmsnorm`` sums a row's squares in a pairwise tree fixed by
the row length alone (padded with +0 to a power of two, halves added
elementwise) and takes 1/√ in float64, so the card and the CPU normalize a
row to the same bits and a row's bits do not depend on the call's shape.
Here: the result equals an explicit scalar emulation of that order bit for
bit, a [B, k+1] call's rows equal the [B, 1] calls' rows, and the gradient
is autograd's of the same expression.  (tests/test_torch_model.py holds the
model's logits to the reference's within 2e-5.)
"""

import numpy as np
import pytest
import torch

from repro_torch.models import layers as L


def _tree(v: list) -> np.float32:
    """The pairwise order, one f32 add at a time: pad to a power of two,
    add element i and element i + P/2, repeat."""
    p = 1
    while p < len(v):
        p *= 2
    v = list(v) + [np.float32(0.0)] * (p - len(v))
    while len(v) > 1:
        h = len(v) // 2
        v = [np.float32(v[i] + v[i + h]) for i in range(h)]
    return v[0]


def _emulated(x: np.ndarray, scale: np.ndarray, eps: float) -> np.ndarray:
    out = np.empty_like(x)
    for r in range(x.shape[0]):
        sq = [np.float32(a * a) for a in x[r]]
        var = np.float32(np.float32(_tree(sq) / np.float32(x.shape[1])) + np.float32(eps))
        inv = np.float32(1.0 / np.sqrt(np.float64(var)))
        out[r] = (x[r] * inv).astype(np.float32) * scale
    return out


@pytest.mark.parametrize("d", [40, 64, 96, 128])
def test_rmsnorm_equals_the_fixed_order(d):
    rng = np.random.default_rng(d)
    x = (rng.standard_normal((6, d)) * np.exp2(rng.integers(-6, 6, (6, 1)))).astype(np.float32)
    scale = rng.uniform(0.5, 1.5, d).astype(np.float32)
    got = L.rmsnorm({"scale": torch.from_numpy(scale)}, torch.from_numpy(x), 1e-5).numpy()
    np.testing.assert_array_equal(got.view(np.int32), _emulated(x, scale, 1e-5).view(np.int32))


def test_rmsnorm_row_is_independent_of_the_call_shape():
    """A verify's [B, k+1] rows against a decode's [B, 1] rows (bf16, as the
    engine calls it), and a row alone."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((3, 5, 128)).astype(np.float32)).to(torch.bfloat16)
    scale = torch.from_numpy(rng.uniform(0.5, 1.5, 128).astype(np.float32)).to(torch.bfloat16)
    whole = L.rmsnorm({"scale": scale}, x, 1e-6)
    for s in range(5):
        assert torch.equal(whole[:, s:s + 1], L.rmsnorm({"scale": scale}, x[:, s:s + 1], 1e-6))
    assert torch.equal(whole[1, 2], L.rmsnorm({"scale": scale}, x[1, 2], 1e-6))


def test_rmsnorm_gradient_is_autograds_of_the_same_sum():
    """The mean of squares' backward, (g/d)·x added twice, equals autograd's
    through ``sum(x·x) / d`` (the same forward bits here, f64)."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((4, 96))).requires_grad_()
    g = torch.from_numpy(rng.standard_normal((4, 1)))
    (got,) = torch.autograd.grad(L._MeanSquare.apply(x), [x], g)
    (want,) = torch.autograd.grad((x * x).sum(-1, keepdim=True) / 96, [x], g)
    assert torch.equal(got, want)
