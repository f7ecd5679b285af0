"""Parameter trees: the port's own random init, and the JAX package's
params carried over leaf by leaf.

The port keeps the reference's tree paths and its stacked ``[L, ...]`` layer
leaves, so a JAX param tree (as numpy arrays, e.g. from ``jax.device_get``)
maps onto the port's by converting each leaf.  A Mamba1 layer's leaves
(``norm``, ``in_proj``, ``conv_w``, ``conv_b``, ``x_proj``, ``dt_proj`` with
its bias, the f32 ``A_log`` and ``D``, ``out_proj``) sit under ``layers``
as in the reference; a gelu MLP has ``up`` and ``down`` with their biases.
A hybrid (zamba2) has ``mamba_layers`` (Mamba2 leaves stacked [L, ...]:
``norm``, ``in_proj``, ``conv_w``, ``conv_b``, the f32 ``A_log``,
``dt_bias`` and ``D``, ``gate_norm``, ``out_proj``) and one unstacked dense
block ``shared_attn`` in place of ``layers``.
An enc-dec model (whisper) has ``encoder`` (``layers``: dense blocks with
layernorms (``scale`` and ``bias``) and dense biases; ``final_norm``) and
``decoder`` (``layers``: ``self_norm``, ``self_attn``, ``cross_norm``,
``cross_attn``, ``mlp_norm``, ``mlp``; ``final_norm``) beside the tied
``embed``.  A VLM has ``layers`` (dense blocks) and ``cross_layers``
(stacked [n_super, ...]: ``attn_norm``, ``attn``, ``mlp_norm``, ``mlp``
and the two f32 scalar gates ``gate_attn`` and ``gate_mlp``).
A MoE layer's leaves sit under ``layers.moe`` (``router.w``, ``gate``, ``up``, ``down`` with
``[L, E, …]`` expert leaves, and arctic's ``dense_mlp``), on the
reference's paths.  bfloat16 leaves arrive as
``ml_dtypes.bfloat16`` numpy arrays; their bits are reinterpreted, not
rounded.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models.transformer import init_lm


def init_params(cfg: ModelConfig, generator: torch.Generator, device="cuda") -> dict:
    """Random weights at the config's width, depth and dtype, drawn from
    ``generator`` with the reference's init laws (not its draws)."""
    if cfg.family == "hybrid":
        from repro_torch.models.hybrid import init_hybrid_lm

        return init_hybrid_lm(cfg, generator, device)
    if cfg.family == "encdec":
        from repro_torch.models.encdec import init_encdec_lm

        return init_encdec_lm(cfg, generator, device)
    if cfg.family == "vlm":
        from repro_torch.models.vlm import init_vlm_lm

        return init_vlm_lm(cfg, generator, device)
    return init_lm(cfg, generator, device)


def _check_shapes(params: dict, want: dict, cfg: ModelConfig) -> None:
    """Raise unless each dotted path of ``want`` is a leaf of that shape."""
    for path, shape in want.items():
        leaf = params
        for k in path.split("."):
            leaf = leaf.get(k, {}) if isinstance(leaf, dict) else {}
        got = tuple(leaf.shape) if isinstance(leaf, torch.Tensor) else None
        if got != shape:
            raise ValueError(f"{path} is {got}, config {cfg.name} needs {shape}")


def _paths(tree: dict, prefix: str = ""):
    """The dotted paths of a nested dict's leaves."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _paths(v, f"{prefix}{k}.")
        else:
            yield f"{prefix}{k}"


def _leaf(a, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(a.copy()).to(device)


def params_from_jax(np_tree, cfg: ModelConfig, device="cuda") -> dict:
    """JAX param tree (nested dicts of numpy arrays) → the port's tree on
    ``device``.  Raises if the tree does not have the config's layout."""
    def convert(t):
        if isinstance(t, dict):
            return {k: convert(v) for k, v in t.items()}
        return _leaf(t, device)

    params = convert(np_tree)
    body = {"hybrid": {"mamba_layers", "shared_attn"}, "encdec": {"encoder", "decoder"},
            "vlm": {"layers", "cross_layers"}}.get(cfg.family, {"layers"})
    expect = ({"embed"} | body | (set() if cfg.family == "encdec" else {"final_norm"})
              | (set() if cfg.tie_embeddings else {"lm_head"}))
    if set(params) != expect:
        raise ValueError(f"param tree has {sorted(params)}, config {cfg.name} needs "
                         f"{sorted(expect)}")
    L, d, di, n = cfg.num_layers, cfg.d_model, cfg.ssm_expand * cfg.d_model, cfg.ssm_state
    if cfg.family == "ssm":
        _check_shapes(params, {"layers.in_proj.w": (L, d, 2 * di),
                               "layers.A_log": (L, di, n), "layers.D": (L, di)}, cfg)
        return params
    if cfg.family == "hybrid":
        nh, kc = di // cfg.ssm_head_dim, cfg.ssm_conv
        hq = cfg.num_heads * cfg.head_dim_
        want = {f"mamba_layers.{k}": v for k, v in {
            "norm.scale": (L, d), "in_proj.w": (L, d, 2 * di + 2 * n + nh),
            "conv_w": (L, kc, di + 2 * n), "conv_b": (L, di + 2 * n), "A_log": (L, nh),
            "dt_bias": (L, nh), "D": (L, nh), "gate_norm.scale": (L, di),
            "out_proj.w": (L, di, d)}.items()}
        want.update({"shared_attn.attn.wq.w": (d, hq), "shared_attn.attn.wo.w": (hq, d),
                     "shared_attn.attn.wk.w": (d, cfg.num_kv_heads * cfg.head_dim_),
                     "shared_attn.mlp.gate.w": (d, cfg.d_ff),
                     "shared_attn.mlp.down.w": (cfg.d_ff, d), "final_norm.scale": (d,)})
        if not cfg.tie_embeddings:
            want["lm_head.w"] = (d, cfg.vocab_size)
        _check_shapes(params, want, cfg)
        return params
    if cfg.family in ("encdec", "vlm"):
        want = _cross_family_shapes(cfg)
        extra = sorted(set(_paths(params)) - set(want))
        if extra:
            raise ValueError(f"param tree has leaves {extra} that config {cfg.name} lacks")
        _check_shapes(params, want, cfg)
        return params
    wq = params["layers"]["attn"]["wq"]["w"]
    want = (cfg.num_layers, cfg.d_model, cfg.num_heads * cfg.head_dim_)
    if tuple(wq.shape) != want:
        raise ValueError(f"layers.attn.wq.w is {tuple(wq.shape)}, config {cfg.name} needs {want}")
    if cfg.family == "moe":
        moe = params["layers"].get("moe", {})
        want = (cfg.num_layers, cfg.num_experts, cfg.d_model, cfg.d_ff)
        got = tuple(moe["gate"].shape) if "gate" in moe else None
        if got != want or ("dense_mlp" in moe) != cfg.moe_dense_residual:
            raise ValueError(f"layers.moe.gate is {got} (dense_mlp: {'dense_mlp' in moe}), "
                             f"config {cfg.name} needs {want} (dense_mlp: "
                             f"{cfg.moe_dense_residual})")
    return params


def _cross_family_shapes(cfg: ModelConfig) -> dict:
    """Every leaf's shape of an enc-dec or VLM param tree, by dotted path."""
    d, f, hd = cfg.d_model, cfg.d_ff, cfg.head_dim_
    hq, hkv = cfg.num_heads * hd, cfg.num_kv_heads * hd

    def dense(name, d_in, d_out):
        out = {f"{name}.w": (d_in, d_out)}
        if cfg.use_bias:
            out[f"{name}.b"] = (d_out,)
        return out

    def norm(name):
        out = {f"{name}.scale": (d,)}
        if cfg.norm == "layernorm":
            out[f"{name}.bias"] = (d,)
        return out

    def attn(name):
        out = {**dense(f"{name}.wq", d, hq), **dense(f"{name}.wk", d, hkv),
               **dense(f"{name}.wv", d, hkv), **dense(f"{name}.wo", hq, d)}
        if cfg.qk_norm:
            out.update({f"{name}.q_norm.scale": (hd,), f"{name}.k_norm.scale": (hd,)})
        return out

    def mlp(name):
        out = {**dense(f"{name}.up", d, f), **dense(f"{name}.down", f, d)}
        if cfg.mlp == "swiglu":
            out.update(dense(f"{name}.gate", d, f))
        return out

    def stacked(prefix, n, leaves):
        return {f"{prefix}.{k}": (n, *v) for k, v in leaves.items()}

    dense_block = {**norm("attn_norm"), **attn("attn"), **norm("mlp_norm"), **mlp("mlp")}
    want = {"embed.table": (cfg.vocab_size, d)}
    if cfg.family == "encdec":
        dec = {**norm("self_norm"), **attn("self_attn"), **norm("cross_norm"),
               **attn("cross_attn"), **norm("mlp_norm"), **mlp("mlp")}
        want.update(stacked("encoder.layers", cfg.encoder_layers, dense_block))
        want.update(stacked("decoder.layers", cfg.num_layers, dec))
        want.update({f"encoder.{k}": v for k, v in norm("final_norm").items()})
        want.update({f"decoder.{k}": v for k, v in norm("final_norm").items()})
    else:
        n_super = cfg.num_layers // cfg.cross_attn_every
        cross = {**norm("attn_norm"), **attn("attn"), **norm("mlp_norm"), **mlp("mlp"),
                 "gate_attn": (), "gate_mlp": ()}
        want.update(stacked("layers", cfg.num_layers, dense_block))
        want.update(stacked("cross_layers", n_super, cross))
        want.update(norm("final_norm"))
    if not cfg.tie_embeddings:
        want.update(dense("lm_head", d, cfg.vocab_size))
    return want
