"""Rope's one sin/cos on every device.

``models.layers`` builds the inverse frequencies once on the host in
float64 from the reference's formula and rounds them once to f32; an angle
is one f32 product (IEEE, the same on every device); its cos and sin are
taken in float64 and rounded once to f32.  A forward builds the table once
(``layers.rope_table``) and hands it to every layer.

Tolerances.  The reference computes 1/θ^(2i/hd) with XLA's f32 ``pow``:
within 1 ulp of the float64 value (15% of entries differ by that ulp).  Its
f32 ``cos``/``sin`` are within 1 ulp of the correctly rounded values.  So
on equal angles the tables agree within 1 ulp; through apply_rope at
positions < P the rotated values differ by at most the angle's error,
|x|·(P·2^-23 + 2^-22), plus the 1-ulp tables' 2^-23·|x|: checked at 2·|x|·
(P + 4)·2^-23.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import layers as RL
from repro_torch.configs import get_reduced_config
from repro_torch.convert import init_params
from repro_torch.models import build_model
from repro_torch.models import layers as L

WIDTHS = [(32, 1e4), (64, 1e5), (128, 1e6), (128, 1e4)]


def _ulps(a: np.ndarray, b: np.ndarray) -> int:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return int(np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32)).max())


@pytest.mark.parametrize("hd,theta", WIDTHS)
def test_inv_freq_within_one_ulp_of_reference(hd, theta):
    got = L.rope_freqs(hd, theta, "cpu").numpy()
    exps = np.arange(0, hd, 2, dtype=np.float64) / hd
    np.testing.assert_array_equal(got, (1.0 / np.power(theta, exps)).astype(np.float32))
    assert _ulps(got, np.asarray(RL.rope_freqs(hd, theta))) <= 1


@pytest.mark.parametrize("hd,theta", WIDTHS)
def test_tables_are_the_rounded_float64_cos_sin(hd, theta):
    """cos/sin of the port's own f32 angles: exactly float64's rounded once,
    and within 1 ulp of XLA's f32 cos/sin of the same angles."""
    pos = np.random.default_rng(hd).integers(0, 40000, (3, 7)).astype(np.int32)
    cos, sin = L.rope_table(torch.from_numpy(pos), hd, theta)
    assert cos.shape == (3, 7, 1, hd // 2) and cos.dtype == torch.float32
    ang = (pos[..., None].astype(np.float32) * L.rope_freqs(hd, theta, "cpu").numpy()
           ).astype(np.float32)
    np.testing.assert_array_equal(cos[:, :, 0].numpy(),
                                  np.cos(ang.astype(np.float64)).astype(np.float32))
    np.testing.assert_array_equal(sin[:, :, 0].numpy(),
                                  np.sin(ang.astype(np.float64)).astype(np.float32))
    assert _ulps(cos[:, :, 0].numpy(), np.asarray(jnp.cos(jnp.asarray(ang)))) <= 1
    assert _ulps(sin[:, :, 0].numpy(), np.asarray(jnp.sin(jnp.asarray(ang)))) <= 1


@pytest.mark.parametrize("hd,theta", WIDTHS)
def test_apply_rope_against_reference(hd, theta):
    P = 64
    rng = np.random.default_rng(hd + 1)
    x = rng.standard_normal((2, P, 3, hd)).astype(np.float32)
    pos = np.broadcast_to(np.arange(P, dtype=np.int32), (2, P)).copy()
    pos[1] = rng.integers(0, P, P)  # a row at other offsets (serving)
    want = np.asarray(RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta, shared=False))
    got = L.apply_rope(torch.from_numpy(x), *L.rope_table(torch.from_numpy(pos), hd, theta))
    tol = 2 * np.abs(x).max() * (P + 4) * 2.0 ** -23
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)


def test_verify_rows_equal_decode_rows():
    """A [B, 5] call's rows against five [B, 1] calls: the tables and the
    rotated values, bit for bit (bf16, as the engine calls it)."""
    rng = np.random.default_rng(5)
    pos = torch.from_numpy(rng.integers(0, 4000, (4, 5)).astype(np.int32))
    x = torch.from_numpy(rng.standard_normal((4, 5, 2, 128)).astype(np.float32)).to(torch.bfloat16)
    cos, sin = L.rope_table(pos, 128, 1e6)
    whole = L.apply_rope(x, cos, sin)
    for s in range(5):
        c1, s1 = L.rope_table(pos[:, s:s + 1], 128, 1e6)
        assert torch.equal(c1, cos[:, s:s + 1]) and torch.equal(s1, sin[:, s:s + 1])
        assert torch.equal(whole[:, s:s + 1], L.apply_rope(x[:, s:s + 1], c1, s1))


def test_forward_builds_the_table_once(monkeypatch):
    cfg = get_reduced_config("qwen3-1.7b", num_layers=3)
    params = init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    calls = []
    table = L.rope_table
    monkeypatch.setattr(L, "rope_table", lambda *a: calls.append(1) or table(*a))
    with torch.no_grad():
        build_model(cfg).forward(params, torch.zeros((2, 8), dtype=torch.int32), 0,
                                 method="bf16")
    assert len(calls) == 1
