"""PyTorch port vs the JAX reference: the MXFP4 pool-health reductions.

Seeded numpy packed pools (head dims 128 and 112: blocks of 32 and the
head-wide block of one scale a row) and packed ring planes go through both
packages' ``pool_health`` and ``ring_health`` with the same page masks, and
both packages' ``StatePool`` (reduced zamba2-7b at two heads of 112: the
attention-KV plane and the Mamba2 rings; reduced whisper-tiny: the self-
and cross-KV planes) filled with the same bytes go through
``sample_state_health``: clip and zero fractions, the 256-bin E8M0
histogram and the element counts must be equal exactly.  Page 0 (the
scratch page) is never counted, no mapped page gives ``None``, and a dense
pool gives ``None``, in both.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced_config as jget_reduced
from repro.models import build_model as jbuild
from repro.serve.paged_cache import PagedCache as JPagedCache
from repro.serve.state_pool import StatePool as JStatePool
from repro.serve.telemetry import quant_health as JQ
from repro_torch.configs import get_reduced_config
from repro_torch.kernels.kv_pack import E2M1_SAT_IDX
from repro_torch.models import build_model
from repro_torch.serve.paged_cache import PagedCache
from repro_torch.serve.state_pool import StatePool
from repro_torch.serve.telemetry import quant_health as TQ


def _pool(rng, L, P, ps, H, hd):
    block = 32 if hd % 32 == 0 else hd
    shapes = {"k_codes": (L, P, ps, H, hd // 2), "k_scales": (L, P, ps, H, hd // block),
              "v_codes": (L, P, ps, H, hd // 2), "v_scales": (L, P, ps, H, hd // block)}
    out = {}
    for name, shape in shapes.items():
        if "codes" in name:
            out[name] = rng.integers(0, 256, shape, dtype=np.uint8)
        else:
            out[name] = rng.integers(96, 160, shape, dtype=np.uint8)
    return out


def _same_health(t: dict, j: dict) -> None:
    """The port's Python numbers equal the reference's arrays exactly."""
    assert t.keys() == j.keys()
    for key, tv in t.items():
        jv = j[key]
        if isinstance(tv, dict):
            _same_health(tv, jv)
        elif isinstance(tv, list):
            assert tv == np.asarray(jv).tolist(), key
        else:
            assert type(tv) in (int, float), (key, type(tv))
            assert tv == float(jv), (key, tv, float(jv))


def test_sat_index_matches_reference():
    from repro.kernels.kv_pack import E2M1_SAT_IDX as J_SAT
    assert E2M1_SAT_IDX == J_SAT == 7


@pytest.mark.parametrize("hd", [128, 112])
def test_pool_health_equal(hd):
    rng = np.random.default_rng(hd)
    pool = _pool(rng, 2, 9, 4, 2, hd)
    tables = np.array([[0, 3, 5, 0], [8, 0, 0, 0], [0, 0, 0, 0]], np.int32)
    mask = TQ.page_mask_from_tables(tables, 9)
    assert (mask == JQ.page_mask_from_tables(tables, 9)).all()
    assert not mask[0] and mask.sum() == 3  # page 0 never counted
    # a pool whose scratch page holds only saturated codes: it must not move the clip rate
    pool["k_codes"][:, 0] = 0x77
    tp = {k: torch.from_numpy(v.copy()) for k, v in pool.items()}
    jp = {k: jnp.asarray(v.copy()) for k, v in pool.items()}
    t = TQ.pool_health(tp, mask)
    _same_health(t, JQ.pool_health(jp, jnp.asarray(mask)))
    assert t["k"]["n_elems"] == 3 * 2 * 4 * 2 * hd and sum(t["k"]["scale_hist"]) == \
        3 * 2 * 4 * 2 * (hd // (32 if hd % 32 == 0 else hd))
    # the counts by hand over the mapped pages
    sel = pool["v_codes"][:, mask]
    mags = np.stack([(sel >> 4) & 7, sel & 7])
    assert t["v"]["clip_frac"] == float(np.float32((mags == 7).sum()) / np.float32(mags.size))


def test_ring_health_equal():
    rng = np.random.default_rng(3)
    ring = {"codes": rng.integers(0, 256, (7, 48), dtype=np.uint8),
            "scales": rng.integers(100, 140, (7, 3), dtype=np.uint8)}
    ring["codes"][0] = 0  # the zero sentinel
    for mask in (np.array([0, 1, 0, 1, 1, 0, 0], bool), np.array([1, 0, 0, 0, 0, 0, 1], bool)):
        t = TQ.ring_health({k: torch.from_numpy(v) for k, v in ring.items()}, mask)
        _same_health(t, JQ.ring_health({k: jnp.asarray(v) for k, v in ring.items()},
                                       jnp.asarray(mask)))


def _fill_pools(rng, tsp, jsp):
    """Equal random bytes in every plane of both state pools."""
    for name in ("kv", "cross"):
        tp, jp = getattr(tsp, name), getattr(jsp, name)
        if tp is None:
            continue
        new = {}
        for k, v in tp.pool.items():
            lo, hi = (0, 256) if "codes" in k else (100, 150)
            arr = rng.integers(lo, hi, tuple(v.shape), dtype=np.uint8)
            v.copy_(torch.from_numpy(arr))
            new[k] = jnp.asarray(arr.copy())
        jp.pool = new
    for tr, jr in zip(tsp.rings, jsp.rings):
        new = {}
        for k, v in tr.pool.items():
            arr = rng.integers(0 if k == "codes" else 100, 256 if k == "codes" else 150,
                               tuple(v.shape), dtype=np.uint8)
            v.copy_(torch.from_numpy(arr))
            new[k] = jnp.asarray(arr.copy())
        jr.pool = new


@pytest.mark.parametrize("arch,over,kinds", [
    ("zamba2-7b", dict(num_heads=2, num_kv_heads=2, head_dim=112), {"kv", "state"}),
    ("whisper-tiny", {}, {"kv", "cross"}),
])
def test_sample_state_health_equal(arch, over, kinds):
    jcfg = dataclasses.replace(jget_reduced(arch), **over)
    tcfg = dataclasses.replace(get_reduced_config(arch), **over)
    kw = dict(n_slots=3, max_len=40, page_size=8, kv_dtype="mxfp4")
    jsp, tsp = JStatePool(jbuild(jcfg), **kw), StatePool(build_model(tcfg), device="cpu", **kw)
    assert TQ.sample_state_health(tsp) is None and JQ.sample_state_health(jsp) is None
    rng = np.random.default_rng(11)
    _fill_pools(rng, tsp, jsp)
    assert TQ.sample_state_health(tsp) is None  # nothing live yet
    for sp in (tsp, jsp):
        sp.alloc(0, 30)
        sp.alloc(2, 12)
        mask = np.array([True, False, True])
        sp.ring_advance(mask)  # slots 0 and 2 read their first written page
        sp.ring_advance(np.array([True, False, False]))
    assert (tsp.kv.tables == np.asarray(jsp.kv.tables)).all()
    if tsp.rings:
        assert (tsp.ring_page_mask() == jsp.ring_page_mask()).all()
        assert tsp.ring_page_mask().sum() == 2
    t = TQ.sample_state_health(tsp)
    assert set(t) == kinds
    _same_health(t, JQ.sample_state_health(jsp))
    assert tsp.pools()["rings"] == tuple(r.pool for r in tsp.rings)


def test_dense_and_unmapped_pools_give_none():
    jcfg, tcfg = jget_reduced("qwen3-1.7b"), get_reduced_config("qwen3-1.7b")
    kw = dict(n_slots=2, pages_per_slot=3, page_size=8)
    for kv in ("dense", "mxfp4"):
        tc = PagedCache(tcfg, kv_dtype=kv, device="cpu", **kw)
        jc = JPagedCache(jbuild(jcfg), kv_dtype=kv, **kw)
        assert TQ.sample_pool_health(tc) is None and JQ.sample_pool_health(jc) is None
        assert tc.occupancy() == jc.occupancy() == 0.0
        for c in (tc, jc):
            c.alloc(1, 20)
        assert tc.occupancy() == jc.occupancy() == 3 / 6
        assert (TQ.sample_pool_health(tc) is None) == (kv == "dense")
    tsp = StatePool(build_model(get_reduced_config("falcon-mamba-7b")), n_slots=2, max_len=16,
                    kv_dtype="dense", device="cpu")
    tsp.alloc(0, 8)
    tsp.ring_advance(np.array([True, False]))
    assert TQ.sample_state_health(tsp) is None
