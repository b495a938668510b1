"""The reference's opt-outs in the port, plain PyTorch as the reference's
are XLA: the gathered-view attention (``attn_impl="xla"``) and the naive
GEMM (``mp_matmul(impl="naive")``, ``dense_matmul``).

* ``paged_kvcache.gather_view`` / ``live_ctx`` and ``kvcache.dequant_k`` /
  ``dequant_v`` against the JAX package's, bit for bit: a pool of random
  stored values (every cell, mapped or not) behind a shuffled block table
  with a sentinel tail, every KV format.
* ``attention.decode_attention(impl="dequant_first")`` against JAX's, and
  ``models.common.attend_decode(impl="xla")`` on the pool against the
  dense slab holding the same tokens: the same rounding points, sums in
  other orders — |Δ| ≤ 2e-2 on outputs of magnitude ≤ ~3, as the fused
  path's parity test.
* Engines: an ``attn_impl="xla"`` engine of the port serves the JAX
  ``attn_impl="xla"`` engine's greedy streams on smollm-360m REDUCED, on
  both backends (the same parameters through ``params_from_jax``), up to
  a near-tie of the reference's logits.
* GEMMs: ``mp_matmul(impl="naive")`` and ``dense_matmul`` against JAX's,
  |Δ| ≤ 2^-7 · max |y| (one bf16 ulp: the same bf16 operands, f32 sums in
  other orders).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_reduced
from repro.core import attention as JA
from repro.core import gemm as JG
from repro.core import kvcache as JKV
from repro.core import packing as JP
from repro.core import paged_kvcache as JPKV
from repro.core import precision as JPR
from repro.core import quantize as JQ
from repro.models import transformer as JT
from repro.serving import Engine as JEngine
from repro.serving import EngineConfig as JEngineConfig
from repro.serving import SamplingParams as JSamplingParams
from repro_torch.configs import get_reduced
from repro_torch.convert import params_from_jax, to_tensor
from repro_torch.core import attention as TA
from repro_torch.core import gemm as TG
from repro_torch.core import kvcache as TKV
from repro_torch.core import packing as TP
from repro_torch.core import paged_kvcache as TPKV
from repro_torch.core import precision as TPR
from repro_torch.models import common as TC
from repro_torch.serving import Engine, EngineConfig, SamplingParams
from torch_defaults import package_defaults  # noqa: F401

# tiny tensors: one intra-op thread avoids the barrier waits that
# dominate when pytest-xdist workers share the cores
torch.set_num_threads(1)

FORMATS = ["kv8", "kv4", "kvfp8", "kv16"]


def _t(a):
    return to_tensor(np.asarray(a), "cpu")


def _bits(t: torch.Tensor) -> np.ndarray:
    """A tensor's bytes, for bitwise comparison of any dtype."""
    return t.contiguous().view(torch.uint8).numpy()


def _stored(rng, shape, fmt, D):
    """Random K/V stored in ``fmt`` with their f32 scales (JAX's
    quantizer), ``shape`` = leading axes of (..., H)."""
    spec = JPR.get_policy(f"w4a16{fmt}").kv
    x = jnp.asarray(rng.standard_normal(shape + (D,)), jnp.bfloat16)
    return JQ.quantize_kv(x, spec)


def _pool_pair(seed, fmt, B=3, nb=11, bs=4, H=2, D=32, bps=4):
    """A per-layer JAX pool whose every cell holds stored values, its
    table shuffled with a sentinel tail, and the port's view of it."""
    rng = np.random.default_rng(seed)
    k, ks = _stored(rng, (nb, bs, H), fmt, D)
    v, vs = _stored(rng, (nb, bs, H), fmt, D)
    tbl = np.full((B, bps), nb, np.int32)
    order = rng.permutation(nb)
    for b, n in enumerate((4, 1, 3)):
        tbl[b, :n] = order[3 * b:3 * b + n]
    cj = JPKV.PagedKVCache(k=k, v=v, k_scale=ks, v_scale=vs,
                           block_table=jnp.asarray(tbl),
                           length=jnp.zeros((B,), jnp.int32))
    ct = TPKV.PagedKVCache(k=_t(k), v=_t(v), k_scale=_t(ks[..., 0]),
                           v_scale=_t(vs[..., 0]),
                           block_table=torch.from_numpy(tbl))
    return cj, ct


@pytest.mark.parametrize("fmt", FORMATS)
def test_gather_view_bitwise(fmt):
    """The whole table, a live bound inside it, and a view wider than the
    table (clamp-padded) — every byte of k, v and the scales."""
    cj, ct = _pool_pair(0, fmt)
    for max_live in (None, 5, 9, 16):
        n_ctx = TPKV.live_ctx(ct, max_live)
        if max_live is not None:
            assert n_ctx == JPKV.live_ctx(cj, max_live)
        vj = JPKV.gather_view(cj, n_ctx=n_ctx)
        vt = TPKV.gather_view(ct, n_ctx=n_ctx)
        for a, b in ((vt.k, vj.k), (vt.v, vj.v)):
            np.testing.assert_array_equal(_bits(a), _bits(_t(b)))
        for a, b in ((vt.k_scale, vj.k_scale), (vt.v_scale, vj.v_scale)):
            np.testing.assert_array_equal(_bits(a), _bits(_t(b[..., 0])))
    wide = TPKV.gather_view(ct, n_ctx=24)             # past the 16 mapped
    np.testing.assert_array_equal(
        _bits(wide.k), _bits(_t(JPKV.gather_view(cj, n_ctx=24).k)))
    with pytest.raises(ValueError, match="block_size"):
        TPKV.gather_view(ct, n_ctx=6)


def test_live_ctx_without_bound_is_the_whole_table():
    _, ct = _pool_pair(1, "kv8")
    assert TPKV.live_ctx(ct) == ct.max_context == 16
    assert TPKV.live_ctx(ct, 100) == 16


@pytest.mark.parametrize("fmt", FORMATS)
def test_dequant_k_v_bitwise(fmt):
    rng = np.random.default_rng(2)
    spec_j = JPR.get_policy(f"w4a16{fmt}").kv
    spec_t = TPR.get_policy(f"w4a16{fmt}").kv
    k, ks = _stored(rng, (2, 5, 2), fmt, 32)
    v, vs = _stored(rng, (2, 5, 2), fmt, 32)
    cj = JKV.KVCache(k=k, v=v, k_scale=ks, v_scale=vs,
                     length=jnp.zeros((2,), jnp.int32))
    ct = TKV.KVCache(k=_t(k), v=_t(v), k_scale=_t(ks[..., 0]),
                     v_scale=_t(vs[..., 0]))
    for fj, ft in ((JKV.dequant_k, TKV.dequant_k),
                   (JKV.dequant_v, TKV.dequant_v)):
        a, b = ft(ct, spec_t), fj(cj, spec_j)
        assert a.dtype == torch.bfloat16 and a.shape == b.shape
        np.testing.assert_array_equal(_bits(a), _bits(_t(b)))


@pytest.mark.parametrize("fmt", FORMATS)
def test_decode_attention_dequant_first_matches_jax(fmt):
    rng = np.random.default_rng(3)
    spec_j = JPR.get_policy(f"w4a16{fmt}").kv
    spec_t = TPR.get_policy(f"w4a16{fmt}").kv
    k, ks = _stored(rng, (2, 24, 2), fmt, 32)
    v, vs = _stored(rng, (2, 24, 2), fmt, 32)
    cj = JKV.KVCache(k=k, v=v, k_scale=ks, v_scale=vs,
                     length=jnp.zeros((2,), jnp.int32))
    ct = TKV.KVCache(k=_t(k), v=_t(v), k_scale=_t(ks[..., 0]),
                     v_scale=_t(vs[..., 0]))
    q = jnp.asarray(rng.standard_normal((2, 3, 6, 32)), jnp.bfloat16)
    pos = np.array([20, 9], np.int32)
    for window in (None, 8):
        oj = JA.decode_attention(q, cj, spec_j, jnp.asarray(pos),
                                 window=window, impl="dequant_first")
        ot = TA.decode_attention(_t(q), ct, spec_t, torch.from_numpy(pos),
                                 window=window, impl="dequant_first")
        err = np.abs(ot.float().numpy() - np.asarray(oj, np.float32)).max()
        assert err <= 2e-2, err


@pytest.mark.parametrize("fmt", FORMATS)
def test_attend_decode_xla_pool_matches_slab(fmt):
    """The gathered view of a pool (T 3 rows, live bound from the engine)
    against the dense slab holding the same tokens, both through the fused
    attention, and against the JAX package's xla route on the pool."""
    from repro.models import common as JC
    cj, ct = _pool_pair(4, fmt)
    spec_j = JPR.get_policy(f"w4a16{fmt}").kv
    spec_t = TPR.get_policy(f"w4a16{fmt}").kv
    view = TPKV.gather_view(ct)                   # the slab: same tokens
    slab = TKV.KVCache(k=view.k.clone(), v=view.v.clone(),
                       k_scale=view.k_scale.clone(),
                       v_scale=view.v_scale.clone())
    rng = np.random.default_rng(5)
    q = jnp.asarray(rng.standard_normal((3, 3, 4, 32)), jnp.bfloat16)
    pos = np.array([10, 1, 8], np.int32)
    kw = dict(window=6, max_live=11)
    oj = JC.attend_decode(q, cj, spec_j, jnp.asarray(pos), impl="xla", **kw)
    ot = TC.attend_decode(_t(q), ct, spec_t, torch.from_numpy(pos),
                          impl="xla", **kw)
    od = TC.attend_decode(_t(q), slab, spec_t, torch.from_numpy(pos),
                          impl="xla", **kw)
    ref = np.asarray(oj, np.float32)
    for out in (ot, od):
        assert np.abs(out.float().numpy() - ref).max() <= 2e-2


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_xla_engine_streams_match_jax_xla_engine(kind):
    """Each request's greedy stream is the JAX xla engine's, up to a
    near-tie: where the two first differ, the port's token must be within
    2e-2 · max |logit| of the reference's own choice in the reference's
    logits over the common prefix (bf16 sums in other orders move logits
    by ~1e-2 of their scale, so a closer race may go either way; after it
    the contexts differ and the streams are not compared)."""
    from repro.core.precision import get_policy as j_policy
    from repro.serving.engine import quantize_params as j_quantize
    cfg_j = j_reduced("smollm-360m")
    kw = dict(policy="w4a16kv8", n_slots=2, max_seq=32, max_prompt=16,
              seed=0, cache_kind=kind, block_size=8, prefill_chunk=4,
              attn_impl="xla")
    raw_j = JT.init_params(cfg_j, jax.random.PRNGKey(0))
    eng_j = JEngine(JEngineConfig(model=cfg_j, **kw), params=raw_j)
    eng_t = Engine(EngineConfig(model=get_reduced("smollm-360m"),
                                device="cpu", **kw),
                   params=params_from_jax(jax.device_get(raw_j),
                                          get_reduced("smollm-360m"),
                                          device="cpu"))
    prompts = np.random.default_rng(6).integers(1, 1024, (3, 11)).tolist()
    prompts[1] = prompts[1][:6]
    got = [[o.output_token_ids for o in eng.generate(prompts, SP(
        max_new_tokens=8))] for eng, SP in ((eng_j, JSamplingParams),
                                             (eng_t, SamplingParams))]
    pol = j_policy("w4a16kv8")
    params = j_quantize(raw_j, pol)
    same = 0
    for prompt, sj, st in zip(prompts, *got):
        assert len(st) == len(sj) == 8
        if st == sj:
            same += 1
            continue
        i = next(i for i, (a, b) in enumerate(zip(sj, st)) if a != b)
        prefix = prompt + sj[:i]
        logits, _ = JT.decode_step(params, cfg_j, pol, jnp.asarray([prefix]),
                                   JT.init_cache(cfg_j, pol, 1, 32),
                                   jnp.int32(0))
        lg = np.asarray(logits[0], np.float32)
        assert lg.argmax() == sj[i]
        assert lg[sj[i]] - lg[st[i]] <= 2e-2 * np.abs(lg).max(), i
    assert same >= 2


@pytest.mark.parametrize("M", [3, 12])
@pytest.mark.parametrize("policy", ["w4a16kv8", "w8a16kv8"])
def test_naive_and_dense_matmul_match_jax(policy, M):
    rng = np.random.default_rng(M)
    K, N = 320, 640
    w = rng.standard_normal((K, N)).astype(np.float32) / K ** 0.5
    x = jnp.asarray(rng.standard_normal((M, K)), jnp.bfloat16)
    pol_j, pol_t = JPR.get_policy(policy), TPR.get_policy(policy)
    bits = pol_t.weights.bits
    pj = JP.pack_weight(jnp.asarray(w), bits=bits, group=64, block_k=64,
                        block_n=128)
    pt = TP.pack_weight(torch.from_numpy(w), bits=bits, group=64,
                        block_k=64, block_n=128)
    pairs = [(TG.mp_matmul(_t(x), pt, pol_t, impl="naive"),
              JG.mp_matmul(x, pj, pol_j, impl="naive")),
             (TG.dense_matmul(_t(x), torch.from_numpy(w)),
              JG.dense_matmul(x, jnp.asarray(w)))]
    for yt, yj in pairs:
        assert yt.dtype == torch.bfloat16
        yj = np.asarray(yj, np.float32)
        err = np.abs(yt.float().numpy() - yj).max()
        assert err <= 2 ** -7 * np.abs(yj).max(), err
    with pytest.raises(ValueError, match="impl"):
        TG.mp_matmul(_t(x), pt, pol_t, impl="xla")


def test_xla_route_logits_match_kernel_route():
    """smollm REDUCED teacher-forced on the slab: the xla route (K/V
    scales on the scores and probabilities) against the kernel route's
    plain version (scales on K/V before the dots) — not bitwise, within
    2e-2 · max |logit|."""
    from repro_torch.models import transformer as TT
    from repro_torch.serving.engine import quantize_params
    cfg = get_reduced("smollm-360m")
    pol = TPR.get_policy("w4a16kv8")
    params = quantize_params(TT.init_params(cfg, seed=0, device="cpu"), pol)
    toks = torch.from_numpy(np.random.default_rng(7).integers(
        1, cfg.vocab, (2, 12)))
    caches = {i: TT.init_cache(cfg, pol, 2, 16, device="cpu")
              for i in ("kernel", "xla")}
    for p, n in ((0, 8), (8, 1), (9, 1), (10, 2)):
        out = {i: TT.decode_step(params, cfg, pol, toks[:, p:p + n],
                                 caches[i], torch.full((2,), p),
                                 attn_block_s=8, attn_impl=i)[0].float()
               for i in caches}
        scale = out["kernel"].abs().max()
        assert (out["xla"] - out["kernel"]).abs().max() <= 2e-2 * scale
