"""The reference's other three dense configurations in the port:
gemma3-1b (5 local : 1 global layers, window 1024, MQA, head dim 288, tied
embeddings), chatglm3-6b (partial RoPE, 32 heads on 2 KV heads) and
mistral-large-123b (88 layers, untied lm_head).

* The configurations are the JAX package's, field for field
  (``test_torch_model.test_config_copy_matches`` runs every arch) and
  carry the assigned hyperparameters (``test_models_smoke``'s table).
* ``layer_window``, the window's reach and partial RoPE: the JAX suite's
  ``TestGemma3Windows`` / ``TestChatGLMPartialRope``, on the port's
  ``decode_step`` (the serving path these configs were ported for).
* Decode attention at head dim 288 (the plain versions of both kernels)
  against the Pallas kernels in interpret mode, every KV format.
* RoPE at theta 1e6 up to position 4096 against JAX: the inverse
  frequencies come from ``pow`` in each framework and differ by an f32
  ulp for some exponents, so angles near 4096 differ by up to ~4e-4 rad
  (|Δ| ≤ 1e-4 observed on unit-scale inputs, held at 2e-4).
* Teacher-forced logits of ``decode_step`` against jitted JAX
  (``attn_impl="pallas"``, the Pallas kernels in interpret mode, GEMMs on
  the engine's ``impl="xla"``) for each REDUCED model and for gemma3
  REDUCED at head dim 288, on the dense slab and on a paged pool with a
  shuffled block table: 8-token prefill chunks (slot 1 ragged) past
  gemma3 REDUCED's window of 32, then single-token steps.  Tolerance as
  ``test_torch_model``: max |Δlogit| ≤ 2e-2 · max |logit| per step (A16:
  bf16 activations through two layers, sums in other orders), top-1 equal
  where JAX's top-2 margin exceeds it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_reduced
from repro.core.precision import get_policy as j_policy
from repro.models import common as JC
from repro.models import transformer as JT
from repro.serving.engine import quantize_params as j_quantize
from repro_torch.configs import get_config, get_reduced
from repro_torch.convert import params_from_jax, to_tensor
from repro_torch.core.precision import get_policy as t_policy
from repro_torch.models import common as TC
from repro_torch.models import transformer as TT
from repro_torch.serving.engine import quantize_params as t_quantize
from torch_defaults import package_defaults  # noqa: F401

# tiny tensors: one intra-op thread avoids the barrier waits that
# dominate when pytest-xdist workers share the cores
torch.set_num_threads(1)

TOL = 2e-2
N_SLOTS, N_BLOCKS, BS, BPS = 2, 16, 8, 7
POLICY = "w4a16kv8"


def test_full_configs_match_assignment():
    """Every ported CONFIG carries the assigned hyperparameters
    (layers, d_model, heads, KV heads, d_ff, vocab, head dim)."""
    spec = {
        "whisper-tiny": (4, 384, 6, 6, 1536, 51865, 64),
        "chatglm3-6b": (28, 4096, 32, 2, 13696, 65024, 128),
        "smollm-360m": (32, 960, 15, 5, 2560, 49152, 64),
        "gemma3-1b": (26, 1152, 4, 1, 6912, 262144, 288),
        "mistral-large-123b": (88, 12288, 96, 8, 28672, 32768, 128),
        "recurrentgemma-2b": (26, 2560, 10, 1, 7680, 256000, 256),
    }
    for arch, want in spec.items():
        cfg = get_config(arch)
        got = (cfg.n_layers, cfg.d_model, cfg.n_heads, cfg.n_kv_heads,
               cfg.d_ff, cfg.vocab, cfg.hd)
        assert got == want, (arch, got)
        assert cfg.source, arch


@pytest.mark.parametrize("arch", ["gemma3-1b", "chatglm3-6b",
                                  "mistral-large-123b"])
def test_layer_window_matches_jax(arch):
    """gemma3: every 6th layer global (the port's BIG_WINDOW, the
    reference's traced one), the rest window 1024; the others global."""
    from repro.models.transformer import layer_window as j_window
    full, red = get_config(arch), get_reduced(arch)
    wins = {}
    for cfg in (full, red):
        wins[cfg.name] = [TT.layer_window(cfg, i) for i in range(cfg.n_layers)]
        assert wins[cfg.name] == [int(j_window(cfg, i))
                                  for i in range(cfg.n_layers)]
    big = TT.BIG_WINDOW
    if arch == "gemma3-1b":
        assert wins[full.name] == [big if i % 6 == 5 else 1024
                                   for i in range(26)]
        assert wins[red.name] == [32, big]              # period 2
    else:
        assert set(wins[full.name]) == set(wins[red.name]) == {big}


def _last_logits(cfg, params, toks):
    """Logits of the last of ``toks`` (one 12-token chunk into a fresh
    dense slab), on the CPU."""
    pol = t_policy(POLICY)
    cache = TT.init_cache(cfg, pol, 1, 16, device="cpu")
    logits, _ = TT.decode_step(params, cfg, pol, torch.tensor([toks]), cache,
                               torch.zeros(1, dtype=torch.int32),
                               attn_block_s=16)
    return logits[0].float()


@pytest.mark.parametrize("window,moves", [(4, False), (None, True)])
def test_window_bounds_what_the_last_token_sees(window, moves):
    """gemma3 REDUCED with every layer local at window 4: token 0 is
    outside the last position's two-layer receptive field (2 × 4), so its
    logits do not move when token 0 changes; with no window they do."""
    cfg = dataclasses.replace(get_reduced("gemma3-1b"), local_global_period=0,
                              window=window)
    params = t_quantize(TT.init_params(cfg, seed=0, device="cpu"),
                        t_policy(POLICY))
    toks = np.random.default_rng(0).integers(1, cfg.vocab, 12).tolist()
    a = _last_logits(cfg, params, toks)
    b = _last_logits(cfg, params, [(toks[0] + 1) % cfg.vocab] + toks[1:])
    d = (a - b).abs().max().item()
    assert (d > 1e-4) if moves else (d < 1e-3), d


def test_rotary_pct_half_leaves_the_trailing_half():
    """chatglm rotates only the leading half of the head dim."""
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (1, 4, 2, 8), np.float32)).to(torch.bfloat16)
    rot = TC.rope_rotation(torch.arange(4)[None], 8, rotary_pct=0.5)
    out = TC.apply_rope(x, rot)
    assert torch.equal(out[..., 4:], x[..., 4:])
    assert not torch.equal(out[..., :4], x[..., :4])


@pytest.mark.parametrize("D", [128, 288])
@pytest.mark.parametrize("pct", [0.5, 1.0])
def test_rope_matches_jax_at_long_positions(pct, D):
    """theta 1e6 (gemma3, mistral) at positions up to 4096, f32 inputs."""
    rng = np.random.default_rng(D)
    x = rng.standard_normal((2, 64, 2, D)).astype(np.float32)
    pos = np.stack([np.arange(64) * 64, 4096 - np.arange(64)]).astype(np.int32)
    rj = np.asarray(JC.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                  rotary_pct=pct, theta=1e6))
    rot = TC.rope_rotation(torch.from_numpy(pos), D, rotary_pct=pct,
                           theta=1e6)
    rt = TC.apply_rope(torch.from_numpy(x), rot).numpy()
    np.testing.assert_allclose(rt, rj, rtol=0, atol=2e-4)


def _stores(fmt, seed, B=2, Hkv=1, D=288, bs=8, bps=4, lengths=(27, 19)):
    """A JAX pool (shuffled table, sentinel tail) and dense slab holding
    the same ``lengths[b]`` random tokens per slot, and the port's views
    of the same bytes."""
    from repro.core import kvcache as JKV
    from repro.core import paged_kvcache as JPKV
    from repro_torch.core import kvcache as TKV
    from repro_torch.core import paged_kvcache as TPKV
    rng = np.random.default_rng(seed)
    spec = j_policy(f"w4a16{fmt}").kv
    nb = B * bps + 2
    tbl = np.full((B, bps), nb, np.int32)
    order = rng.permutation(nb)
    for b, n in enumerate(lengths):
        need = -(-n // bs)
        tbl[b, :need] = order[b * bps:b * bps + need]
    T = max(lengths)
    k = jnp.asarray(rng.standard_normal((B, T, Hkv, D)), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((B, T, Hkv, D)), jnp.bfloat16)
    zero, valid = jnp.zeros((B,), jnp.int32), jnp.asarray(lengths, jnp.int32)
    pj = JPKV.init_paged(B, nb, bs, Hkv, D, spec, blocks_per_slot=bps)
    pj = JPKV.append_paged(dataclasses.replace(pj, block_table=jnp.asarray(
        tbl)), k, v, zero, spec, valid=valid)
    dj = JKV.append_per_slot(JKV.init_cache(B, bps * bs, Hkv, D, spec), k, v,
                             zero, spec, valid=valid)
    t = lambda a: to_tensor(np.asarray(a), "cpu")        # noqa: E731
    pt = TPKV.PagedKVCache(k=t(pj.k), v=t(pj.v), k_scale=t(pj.k_scale[..., 0]),
                           v_scale=t(pj.v_scale[..., 0]),
                           block_table=torch.from_numpy(tbl))
    dt = TKV.KVCache(k=t(dj.k), v=t(dj.v), k_scale=t(dj.k_scale[..., 0]),
                     v_scale=t(dj.v_scale[..., 0]))
    return pj, dj, pt, dt


@pytest.mark.parametrize("T", [1, 4])
@pytest.mark.parametrize("fmt", ["kv8", "kv4", "kvfp8", "kv16"])
def test_attention_at_head_dim_288_matches_pallas(fmt, T):
    """The plain versions of both decode-attention kernels against the
    Pallas kernels in interpret mode at gemma3's head dim 288 (4 query
    heads on 1 KV head), window 10 cutting 19–27-token contexts:
    |Δ| ≤ 2e-2 on outputs of magnitude ≤ ~3 (the same rounding points,
    sums inside a tile in other orders), as ``test_torch_kernels``."""
    from repro.kernels import ops as JOPS
    from repro_torch.kernels import ops as TOPS
    pj, dj, pt, dt = _stores(fmt, seed=T)
    rng = np.random.default_rng(10 + T)
    q = jnp.asarray(rng.standard_normal((2, T, 4, 288)), jnp.bfloat16)
    pos = np.array([27 - T, 19 - T], np.int32)
    spec_j, spec_t = j_policy(f"w4a16{fmt}").kv, t_policy(f"w4a16{fmt}").kv
    qt = to_tensor(np.asarray(q), "cpu")
    pairs = [(JOPS.kvattn_decode_paged(q, pj, spec_j, jnp.asarray(pos),
                                       window=10),
              TOPS.kvattn_decode_paged(qt, pt, spec_t, torch.from_numpy(pos),
                                       window=10)),
             (JOPS.kvattn_decode(q, dj, spec_j, jnp.asarray(pos), window=10,
                                 block_s=8),
              TOPS.kvattn_decode(qt, dt, spec_t, torch.from_numpy(pos),
                                 window=10, block_s=8))]
    for oj, ot in pairs:
        assert ot.shape == tuple(oj.shape)
        err = np.abs(ot.float().numpy() - np.asarray(oj, np.float32)).max()
        assert err <= 2e-2, err


#: the models held against JAX: (arch, head dim override)
MODELS = [("chatglm3-6b", None), ("mistral-large-123b", None),
          ("gemma3-1b", None), ("gemma3-1b", 288)]


def _configs(arch, hd):
    cfg_j, cfg_t = j_reduced(arch), get_reduced(arch)
    if hd is not None:
        cfg_j = dataclasses.replace(cfg_j, head_dim=hd)
        cfg_t = dataclasses.replace(cfg_t, head_dim=hd)
    return cfg_j, cfg_t


@pytest.mark.parametrize("kind", ["dense", "paged"])
@pytest.mark.parametrize("arch,hd", MODELS)
def test_teacher_forced_logits_match_jax(arch, hd, kind):
    cfg_j, cfg_t = _configs(arch, hd)
    pol_j, pol_t = j_policy(POLICY), t_policy(POLICY)
    raw_j = JT.init_params(cfg_j, jax.random.PRNGKey(0))
    params_j = j_quantize(raw_j, pol_j)
    params_t = t_quantize(params_from_jax(jax.device_get(raw_j), cfg_t,
                                          device="cpu"), pol_t)
    assert ("lm_head" in params_t) == (not cfg_t.tie_embeddings)
    rng = np.random.default_rng(1)
    if kind == "paged":
        tbl = rng.permutation(N_BLOCKS)[:N_SLOTS * BPS].reshape(
            N_SLOTS, BPS).astype(np.int32)
        cache_j = JT.init_paged_cache(cfg_j, pol_j, N_SLOTS, N_BLOCKS, BS,
                                      BPS)
        cache_j = dataclasses.replace(cache_j, block_table=jnp.broadcast_to(
            jnp.asarray(tbl), cache_j.block_table.shape))
        cache_t = TT.init_paged_cache(cfg_t, pol_t, N_SLOTS, N_BLOCKS, BS,
                                      BPS, device="cpu")
        cache_t.block_table.copy_(torch.from_numpy(tbl))
    else:
        cache_j = JT.init_cache(cfg_j, pol_j, N_SLOTS, BPS * BS)
        cache_t = TT.init_cache(cfg_t, pol_t, N_SLOTS, BPS * BS,
                                device="cpu")
    step_j = jax.jit(JT.decode_step, static_argnames=(
        "cfg", "policy", "impl", "attn_impl", "attn_block_s", "max_live"))

    # five 8-token chunks (slot 1 has 6 real rows in the last), then two
    # single-token steps: 40 and 38 prompt tokens, past gemma3 REDUCED's
    # window of 32
    stream = rng.integers(1, cfg_t.vocab, (N_SLOTS, 48)).astype(np.int32)
    steps, nxt = [], np.zeros(N_SLOTS, np.int32)
    for valid in [[8, 8]] * 4 + [[8, 6]] + [[1, 1]] * 2:
        T = max(valid)
        toks = np.stack([stream[b, nxt[b]:nxt[b] + T] for b in range(2)])
        steps.append((toks, nxt.copy(), np.array(valid, np.int32)))
        nxt = nxt + valid
    for toks, p, valid in steps:
        if kind == "paged":                 # the engine's live bound
            nb = -(-(int(p.max()) + 1) // BS)
            kw = dict(max_live=min(1 << (nb - 1).bit_length(), BPS) * BS)
        else:
            kw = dict(attn_block_s=BS)
        lj, cache_j = step_j(params_j, cfg_j, pol_j, jnp.asarray(toks),
                             cache_j, jnp.asarray(p), attn_impl="pallas",
                             valid=jnp.asarray(valid), **kw)
        lt, cache_t = TT.decode_step(params_t, cfg_t, pol_t,
                                     torch.from_numpy(toks), cache_t,
                                     torch.from_numpy(p),
                                     valid=torch.from_numpy(valid), **kw)
        lj = to_tensor(np.asarray(lj), "cpu").float().numpy()
        lt = lt.float().numpy()
        assert lt.shape == lj.shape == (N_SLOTS, cfg_t.vocab)
        assert np.isfinite(lt).all()
        scale = np.abs(lj).max()
        assert np.abs(lt - lj).max() <= TOL * scale
        top2 = np.sort(lj, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > TOL * scale
        np.testing.assert_array_equal(lt.argmax(-1)[clear],
                                      lj.argmax(-1)[clear])
