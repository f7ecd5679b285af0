"""State-space blocks: Mamba1 (falcon-mamba-7b) and Mamba2/SSD (zamba2-7b).

Port of ``repro.models.ssm``.  Quartet applies to every projection (Mamba1:
in / x / dt / out; Mamba2: in / out); the recurrences stay in f32.

* Mamba1: the recurrence couples (channel × state) inside an exp, so it
  does not factor into GEMMs: a plain loop over time on the f32 [B, Di, N]
  state, as the reference's ``lax.scan`` (not a Pallas kernel) runs it.
* Mamba2: A is a scalar a head, so the SSD chunked form turns the scan into
  chunk-local attention-like products plus a loop over chunks
  (:func:`ssd_chunk_scan`; the reference's ``lax.scan`` over chunks, not a
  Pallas kernel).  A call of S tokens takes chunks of ``min(chunk, S)``
  halved until it divides S, so a prompt's state depends on how it was
  split into calls, in the port as in the reference.

The projections around the scans carry the FLOPs.  With a cache
``(conv_state [B, K-1, C], h)`` a block starts from that state and writes
its new state into the same tensors in place (a serving step's one token,
or a prefill chunk); without one it starts from zeros (training, a
teacher-forced forward).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as Fn

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def _causal_conv(x: torch.Tensor, w: torch.Tensor, b: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv.  x [B, S, Di], w [K, Di], b [Di]; ``state``
    [B, K-1, Di] holds the previous inputs.  → (y, new_state), the taps
    summed in order k = 0..K-1."""
    K, S = w.shape[0], x.shape[1]
    if state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype, device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)  # [B, K-1+S, Di]
    y = xp[:, 0:S, :] * w[0][None, None, :]
    for k in range(1, K):
        y = y + xp[:, k:k + S, :] * w[k][None, None, :]
    return y + b[None, None, :], xp[:, -(K - 1):, :]


def _finite_or_zero(t: torch.Tensor) -> torch.Tensor:
    return torch.where(torch.isinf(t), torch.zeros_like(t), t)


class _Softplus(torch.autograd.Function):
    """``jax.nn.softplus`` (``logaddexp(x, 0)``) in f32: max(x, 0) +
    log1p(exp(−|x|)), with ``logaddexp``'s own derivative, exp(x − y).
    Autograd through max and |x| would take their subgradients at x = 0 and
    give 1 there, not ½; a Quartet projection's output is exactly 0 often
    enough (sums of FP4 grid values cancel) for that to move dt's gradient."""

    @staticmethod
    def forward(ctx, x):
        y = torch.clamp(x, min=0.0) + torch.log1p(torch.exp(-torch.abs(x)))
        ctx.save_for_backward(x, y)
        return y

    @staticmethod
    def backward(ctx, g):
        x, y = ctx.saved_tensors
        return g * torch.exp(_finite_or_zero(x) - _finite_or_zero(y))


def _softplus(x: torch.Tensor) -> torch.Tensor:
    return _Softplus.apply(x.to(torch.float32))


def init_mamba1_block(cfg: ModelConfig, dtype, generator, device) -> dict:
    """The reference's tree and init laws (not its draws)."""
    d = cfg.d_model
    di = cfg.ssm_expand * d
    n, kc = cfg.ssm_state, cfg.ssm_conv
    r = max(d // 16, 1)
    a = torch.arange(1, n + 1, dtype=torch.float32, device=device)
    return {
        "norm": L.init_rmsnorm(d, dtype, device),
        "in_proj": L.init_dense(d, 2 * di, dtype, generator, device),
        "conv_w": L.trunc_normal((kc, di), 1.0 / np.sqrt(kc * di) * np.sqrt(di), dtype,
                                 generator, device),
        "conv_b": torch.zeros((di,), dtype=dtype, device=device),
        "x_proj": L.init_dense(di, r + 2 * n, dtype, generator, device),
        "dt_proj": L.init_dense(r, di, dtype, generator, device, use_bias=True),
        "A_log": torch.log(a).expand(di, n).contiguous(),
        "D": torch.ones((di,), dtype=torch.float32, device=device),
        "out_proj": L.init_dense(di, d, dtype, generator, device),
    }


def selective_scan(h: torch.Tensor, a: torch.Tensor, bx: torch.Tensor) -> torch.Tensor:
    """h_t = a_t · h_{t−1} + bx_t over time, from ``h`` [B, Di, N] (f32),
    with a, bx [B, S, Di, N] → every h_t, [B, S, Di, N].  A product and a
    sum, each rounded (no fused multiply-add), so a step rounds alike on
    every device.  The steps read a and bx through one ``unbind`` each,
    whose backward stacks the steps' gradients once (indexing ``a[:, t]``
    would have autograd build a full-size gradient of a at every step:
    quadratic in S)."""
    hs = []
    for a_t, bx_t in zip(a.unbind(1), bx.unbind(1)):
        h = a_t * h + bx_t
        hs.append(h)
    return torch.stack(hs, dim=1)


def mamba1_block(params: dict, x: torch.Tensor, positions, seed: int, cfg: ModelConfig,
                 cache, method: str, cache_index=None, token_valid=None, rope=None):
    """x [B, S, D] → (x + out, 0.0: no router loss).  ``cache`` is
    ``(conv_state, h)`` of this layer, updated in place, or None.  The
    positions, cache index, token-valid lanes and rope table of the
    attention blocks' signature are unused: a recurrence has no positions."""
    d = cfg.d_model
    di = cfg.ssm_expand * d
    n, r = cfg.ssm_state, max(d // 16, 1)
    qc = cfg.quartet
    B, S, _ = x.shape
    f32 = torch.float32

    xin = L.rmsnorm(params["norm"], x, cfg.norm_eps)
    xz = L.dense(params["in_proj"], xin, L.seed_fold(seed, 1), qc, method)
    x1, z = xz[..., :di], xz[..., di:]

    conv_state = cache[0] if cache is not None else None
    x1, new_conv = _causal_conv(x1, params["conv_w"].to(f32), params["conv_b"].to(f32),
                                conv_state)
    x1 = Fn.silu(x1.to(f32)).to(x.dtype)

    proj = L.dense(params["x_proj"], x1, L.seed_fold(seed, 2), qc, method).to(f32)
    dt_r, Bm, Cm = proj[..., :r], proj[..., r:r + n], proj[..., r + n:]
    dt = _softplus(L.dense(params["dt_proj"], dt_r.to(x.dtype), L.seed_fold(seed, 3), qc,
                           method))  # [B, S, Di]
    A = -torch.exp(params["A_log"])  # [Di, N], in the parameter's dtype

    a = torch.exp(dt[..., None] * A[None, None])  # [B, S, Di, N] f32
    x1f = x1.to(f32)
    bx = (dt * x1f)[..., None] * Bm[:, :, None, :]

    h0 = cache[1] if cache is not None else torch.zeros((B, di, n), dtype=f32, device=x.device)
    hs = selective_scan(h0, a, bx)
    y = torch.einsum("bsdn,bsn->bsd", hs, Cm) + params["D"][None, None] * x1f
    y = (y * Fn.silu(z.to(f32))).to(x.dtype)
    out = L.dense(params["out_proj"], y, L.seed_fold(seed, 4), qc, method)

    if cache is not None:
        cache[0].copy_(new_conv)
        cache[1].copy_(hs[:, -1])
    return x + out, 0.0


def mamba1_cache_spec(cfg: ModelConfig, batch: int):
    """((shape, dtype) of the conv state, of h) for one layer: conv
    [B, K-1, Di] in the compute dtype, h [B, Di, N] in f32."""
    di = cfg.ssm_expand * cfg.d_model
    return (((batch, cfg.ssm_conv - 1, di), getattr(torch, cfg.dtype)),
            ((batch, di, cfg.ssm_state), torch.float32))


def init_mamba2_block(cfg: ModelConfig, dtype, generator, device) -> dict:
    """The reference's tree and init laws (not its draws)."""
    d = cfg.d_model
    di = cfg.ssm_expand * d
    n, kc, hd = cfg.ssm_state, cfg.ssm_conv, cfg.ssm_head_dim
    nh = di // hd
    a = torch.from_numpy(np.linspace(1.0, 16.0, nh).astype(np.float32)).to(device)
    return {
        "norm": L.init_rmsnorm(d, dtype, device),
        "in_proj": L.init_dense(d, 2 * di + 2 * n + nh, dtype, generator, device),
        "conv_w": L.trunc_normal((kc, di + 2 * n), 1.0 / np.sqrt(kc), dtype, generator, device),
        "conv_b": torch.zeros((di + 2 * n,), dtype=dtype, device=device),
        "A_log": torch.log(a),
        "dt_bias": torch.zeros((nh,), dtype=torch.float32, device=device),
        "D": torch.ones((nh,), dtype=torch.float32, device=device),
        "gate_norm": L.init_rmsnorm(di, dtype, device),
        "out_proj": L.init_dense(di, d, dtype, generator, device),
    }


def ssd_chunk_scan(xh: torch.Tensor, dt: torch.Tensor, A: torch.Tensor, Bm: torch.Tensor,
                   Cm: torch.Tensor, h0: torch.Tensor, chunk: int):
    """SSD over chunks: xh [B, S, nh, hd], dt [B, S, nh] (after softplus), A
    [nh] (< 0), Bm/Cm [B, S, N], h0 [B, nh, hd, N] f32 → (y [B, S, nh, hd],
    h_T [B, nh, hd, N]), both f32.  Chunks of Lc = min(chunk, S), halved
    until Lc divides S; within a chunk, y_t = Σ_{s ≤ t} C_t·B_s ·
    exp(cum_t − cum_s)·dt_s·x_s plus the incoming state's C_t·h·exp(cum_t),
    the mask inside the exp (exp(−1e30) = 0)."""
    B, S, nh, hd = xh.shape
    N = Bm.shape[-1]
    Lc = min(chunk, S)
    while S % Lc != 0:
        Lc //= 2
    nc = S // Lc
    f32 = torch.float32
    xc = xh.reshape(B, nc, Lc, nh, hd).to(f32)
    dtc = dt.reshape(B, nc, Lc, nh)
    Bc = Bm.reshape(B, nc, Lc, N).to(f32)
    Cc = Cm.reshape(B, nc, Lc, N).to(f32)
    cum = torch.cumsum(dtc * A[None, None, None, :], dim=2)  # [B, nc, Lc, nh], negative
    tri = torch.tril(torch.ones((Lc, Lc), dtype=torch.bool, device=xh.device))[None, :, :, None]
    h, ys = h0, []
    for c in range(nc):
        xcb, dtb, Bb, Cb, cumb = xc[:, c], dtc[:, c], Bc[:, c], Cc[:, c], cum[:, c]
        Lmat = cumb[:, :, None, :] - cumb[:, None, :, :]  # [B, t, s, nh]
        decay = torch.exp(torch.where(tri, Lmat, torch.full_like(Lmat, -1e30)))
        CB = torch.einsum("btn,bsn->bts", Cb, Bb)
        scores = CB[..., None] * decay * dtb[:, None, :, :]
        y_intra = torch.einsum("btsh,bshd->bthd", scores, xcb)
        y_inter = torch.einsum("btn,bhdn->bthd", Cb, h) * torch.exp(cumb)[..., None]
        tot = cumb[:, -1:, :]  # [B, 1, nh]
        dec_end = torch.exp(tot - cumb) * dtb  # [B, Lc, nh]
        h = torch.exp(tot[:, 0, :])[:, :, None, None] * h + torch.einsum(
            "bshd,bsn,bsh->bhdn", xcb, Bb, dec_end)
        ys.append(y_intra + y_inter)
    return torch.stack(ys, dim=1).reshape(B, S, nh, hd), h


def mamba2_block(params: dict, x: torch.Tensor, positions, seed: int, cfg: ModelConfig,
                 cache, method: str, cache_index=None, token_valid=None, rope=None):
    """x [B, S, D] → (x + out, 0.0: no router loss).  ``cache`` is ``(conv
    [B, K-1, Di + 2N], h [B, nh, hd, N])`` of this layer, updated in place,
    or None.  The attention blocks' positions, cache index, token-valid
    lanes and rope table are unused."""
    d = cfg.d_model
    di = cfg.ssm_expand * d
    n, hd = cfg.ssm_state, cfg.ssm_head_dim
    nh = di // hd
    qc = cfg.quartet
    B, S, _ = x.shape
    f32 = torch.float32

    xin = L.rmsnorm(params["norm"], x, cfg.norm_eps)
    zxbcdt = L.dense(params["in_proj"], xin, L.seed_fold(seed, 1), qc, method)
    z, xbc, dt_raw = zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * n], zxbcdt[..., 2 * di + 2 * n:]

    conv_state = cache[0] if cache is not None else None
    xbc, new_conv = _causal_conv(xbc, params["conv_w"].to(f32), params["conv_b"].to(f32),
                                 conv_state)
    xbc = Fn.silu(xbc.to(f32))
    x1, Bm, Cm = xbc[..., :di], xbc[..., di:di + n], xbc[..., di + n:]

    dt = _softplus(dt_raw.to(f32) + params["dt_bias"][None, None])  # [B, S, nh]
    A = -torch.exp(params["A_log"])  # [nh], in the parameter's dtype
    xh = x1.reshape(B, S, nh, hd)

    h0 = cache[1] if cache is not None else torch.zeros((B, nh, hd, n), dtype=f32,
                                                        device=x.device)
    y, hT = ssd_chunk_scan(xh, dt, A, Bm, Cm, h0, cfg.ssm_chunk)
    y = (y + params["D"][None, None, :, None] * xh).reshape(B, S, di)
    y = L.rmsnorm(params["gate_norm"], (y * Fn.silu(z.to(f32))).to(x.dtype), cfg.norm_eps)
    out = L.dense(params["out_proj"], y, L.seed_fold(seed, 4), qc, method)

    if cache is not None:
        cache[0].copy_(new_conv)
        cache[1].copy_(hT)
    return x + out, 0.0


def mamba2_cache_spec(cfg: ModelConfig, batch: int):
    """((shape, dtype) of the conv state, of h) for one layer: conv
    [B, K-1, Di + 2N] in the compute dtype, h [B, nh, hd, N] in f32."""
    di = cfg.ssm_expand * cfg.d_model
    nh = di // cfg.ssm_head_dim
    return (((batch, cfg.ssm_conv - 1, di + 2 * cfg.ssm_state), getattr(torch, cfg.dtype)),
            ((batch, nh, cfg.ssm_head_dim, cfg.ssm_state), torch.float32))
