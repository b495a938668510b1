"""The slice as a whole: teacher-forced logits of the port's ``decode_step``
against the JAX package's, on smollm-360m REDUCED (2 layers).

Both packages run the same parameters — JAX ``init_params`` carried across
by ``repro_torch.convert.params_from_jax`` and packed by each package's own
packer (the packed bytes are shown equal) — on a paged cache with a
shuffled block table or on the dense slab: a 4-token prefill chunk with a
ragged ``valid`` mask, then single-token steps.  JAX runs
``decode_step(attn_impl="pallas")`` (the Pallas kernels in interpret mode;
the dense kernel at ``attn_block_s`` = the block size, as the engine sets
it) with the GEMMs on its engine path (``impl="xla"``); the port runs its
plain versions on the CPU.  Policies: w4a16kv8 on both backends, and
w4a8kv4, w8a8kvfp8, w8a16kv16, w16a16kv16 on both.

Tolerance: max |Δlogit| ≤ 2e-2 · max |logit| per step — bf16 activations
through two layers with the GEMM and attention sums taken in other orders
(each ≤ one bf16 ulp per op) — and top-1 agreement wherever JAX's top-2
margin exceeds that tolerance.  A8 policies (w4a8, w8a8) get 1e-1: they
re-quantize every GEMM input per token, and a one-ulp difference upstream
flips int8 roundings (one int8 step is 1/127 of the token's absmax, twice
a bf16 ulp of the largest elements), so differences grow from GEMM to
GEMM.  The reference itself shows it: JAX's two GEMM paths for w8a8
(``impl="xla"`` and the Pallas kernel), which differ only in the f32
order of the group sums, disagree by 1.8e-2 · max |logit| after one
4-token step on this model; the port's largest step error is 6.0e-2
(w4a8kv4), against ≤ 1.0e-2 for every A16 policy.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_config as j_config
from repro.configs import get_reduced as j_reduced
from repro.core.precision import get_policy as j_policy
from repro.models import transformer as JT
from repro.serving.engine import quantize_params as j_quantize
from repro_torch.configs import ARCHS
from repro_torch.configs.base import jax_fields
from repro_torch.configs import get_config as t_config
from repro_torch.configs import get_reduced as t_reduced
from repro_torch.convert import params_from_jax, to_tensor
from repro_torch.core.packing import PackedWeight
from repro_torch.core.precision import get_policy as t_policy
from repro_torch.models import transformer as TT
from repro_torch.serving.engine import quantize_params as t_quantize
from torch_defaults import package_defaults  # noqa: F401

# tiny tensors: one intra-op thread avoids the barrier waits that
# dominate when pytest-xdist workers share the cores
torch.set_num_threads(1)

TOL = 2e-2
TOL_A8 = 1e-1
N_SLOTS, N_BLOCKS, BS, BPS = 2, 10, 8, 4


@pytest.fixture(scope="module")
def raw():
    cfg_j, cfg_t = j_reduced("smollm-360m"), t_reduced("smollm-360m")
    raw_j = JT.init_params(cfg_j, jax.random.PRNGKey(0))
    return cfg_j, cfg_t, raw_j, jax.device_get(raw_j)


@pytest.fixture(scope="module")
def models(raw):
    cfg_j, cfg_t, raw_j, raw_np = raw
    pol_j, pol_t = j_policy("w4a16kv8"), t_policy("w4a16kv8")
    params_j = j_quantize(raw_j, pol_j)
    params_t = t_quantize(params_from_jax(raw_np, cfg_t, device="cpu"),
                          pol_t)
    return cfg_j, cfg_t, pol_j, pol_t, params_j, params_t


def test_rms_norm_and_interleaved_rope_match_jax():
    """RMSNorm scales by 1 + g; RoPE rotates interleaved pairs.  f32
    inputs, tolerance 1e-5 relative (transcendentals differ by ulps)."""
    from repro.models import common as JC
    from repro_torch.models import common as TC
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 3, 64)).astype(np.float32)
    g = rng.standard_normal(64).astype(np.float32)
    pos = np.array([[0, 1, 2, 3, 4], [7, 8, 9, 10, 11]], np.int32)
    nj = np.asarray(JC.rms_norm(jnp.asarray(x), jnp.asarray(g)))
    nt = TC.rms_norm(torch.from_numpy(x), torch.from_numpy(g)).numpy()
    np.testing.assert_allclose(nt, nj, rtol=1e-5, atol=1e-5)
    for pct in (1.0, 0.5):
        rj = np.asarray(JC.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                                      rotary_pct=pct))
        rot = TC.rope_rotation(torch.from_numpy(pos), 64, rotary_pct=pct)
        rt = TC.apply_rope(torch.from_numpy(x), rot).numpy()
        np.testing.assert_allclose(rt, rj, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_copy_matches(arch):
    """Every ported configuration, full and REDUCED, field for field the
    JAX package's, with the port's own fields at their defaults."""
    for t_get, j_get in ((t_reduced, j_reduced), (t_config, j_config)):
        assert jax_fields(t_get(arch)) == dataclasses.asdict(j_get(arch))


def test_packed_weights_equal_jax(models):
    _, cfg_t, _, _, params_j, params_t = models
    for name in ("wq", "wk", "wv", "wo", "w1", "w2", "w3"):
        pj = params_j["layers"][name]
        for i in range(cfg_t.n_layers):
            pt = params_t["layers"][i][name]
            assert isinstance(pt, PackedWeight)
            assert (pt.block_k, pt.block_n, pt.group) == \
                (pj.block_k, pj.block_n, pj.group)
            np.testing.assert_array_equal(pt.data.numpy(),
                                          np.asarray(pj.data[i]))
            np.testing.assert_array_equal(
                pt.scales.numpy().view(np.uint32),
                np.asarray(pj.scales[i]).view(np.uint32))


def _live_bucket(pos_max: int) -> int:
    """The engine's max_live: max(pos)+1 in pow2 whole blocks."""
    nb = -(-(pos_max + 1) // BS)
    return min(1 << (nb - 1).bit_length(), BPS) * BS


def _teacher_forced(cfg_j, cfg_t, pol_j, pol_t, params_j, params_t, kind):
    """Run both packages' decode_step over the same steps on a fresh
    cache of ``kind`` and hold the logits together at every step."""
    tol = TOL_A8 if pol_t.int8_matmul else TOL
    tbl = np.array([[3, 7, 1, N_BLOCKS], [5, 0, N_BLOCKS, N_BLOCKS]],
                   np.int32)
    if kind == "paged":
        cache_j = JT.init_paged_cache(cfg_j, pol_j, N_SLOTS, N_BLOCKS, BS,
                                      BPS)
        cache_j = dataclasses.replace(cache_j, block_table=jnp.broadcast_to(
            jnp.asarray(tbl), cache_j.block_table.shape))
        cache_t = TT.init_paged_cache(cfg_t, pol_t, N_SLOTS, N_BLOCKS, BS,
                                      BPS, device="cpu")
        cache_t.block_table.copy_(torch.from_numpy(tbl))
    else:
        cache_j = JT.init_cache(cfg_j, pol_j, N_SLOTS, BPS * BS)
        cache_t = TT.init_cache(cfg_t, pol_t, N_SLOTS, BPS * BS, device="cpu")
    step_j = jax.jit(JT.decode_step, static_argnames=(
        "cfg", "policy", "impl", "attn_impl", "attn_block_s", "max_live"))

    rng = np.random.default_rng(0)
    stream = rng.integers(1, cfg_t.vocab, (N_SLOTS, 12)).astype(np.int32)
    # (tokens, first position, valid rows) per step: a 4-token chunk where
    # slot 1 has only 3 real rows, then single-token steps
    pos = np.array([0, 0], np.int32)
    steps = [(stream[:, 0:4], pos.copy(), np.array([4, 3], np.int32))]
    nxt = pos + steps[0][2]
    for _ in range(5):
        toks = np.stack([stream[b, nxt[b]:nxt[b] + 1] for b in range(2)])
        steps.append((toks, nxt.copy(), np.array([1, 1], np.int32)))
        nxt = nxt + 1
    for toks, p, valid in steps:
        # paged: the engine's live bound; dense: the engine's tile height
        kw = (dict(max_live=_live_bucket(int(p.max()))) if kind == "paged"
              else dict(attn_block_s=BS))
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
        assert np.abs(lt - lj).max() <= tol * scale
        top2 = np.sort(lj, axis=-1)[:, -2:]
        clear = (top2[:, 1] - top2[:, 0]) > tol * scale
        np.testing.assert_array_equal(lt.argmax(-1)[clear],
                                      lj.argmax(-1)[clear])


def test_teacher_forced_logits_match_jax(models):
    _teacher_forced(*models, "paged")


def test_teacher_forced_logits_match_jax_dense(models):
    _teacher_forced(*models, "dense")


@pytest.mark.parametrize("kind", ["dense", "paged"])
@pytest.mark.parametrize("policy", ["w4a8kv4", "w8a8kvfp8", "w8a16kv16",
                                    "w16a16kv16"])
def test_teacher_forced_logits_other_policies(raw, policy, kind):
    """Every GEMM route (A16 bits 4/8, int8 bits 4/8, unpacked bf16) and
    every KV format, on both backends."""
    cfg_j, cfg_t, raw_j, raw_np = raw
    pol_j, pol_t = j_policy(policy), t_policy(policy)
    params_t = t_quantize(params_from_jax(raw_np, cfg_t, device="cpu"),
                          pol_t)
    packed = isinstance(params_t["layers"][0]["wq"], PackedWeight)
    assert packed == (policy[:3] != "w16")
    _teacher_forced(cfg_j, cfg_t, pol_j, pol_t, j_quantize(raw_j, pol_j),
                    params_t, kind)


def test_dense_sinusoidal_positions_not_ported(models):
    """Formerly "not yet ported" (ROADMAP queue 1 item 8): the dense decode
    step takes ``use_rope=False`` — sinusoidal positions added to the
    embeddings, no RoPE — and its logits depend on the position
    (``tests/test_torch_sinusoidal.py`` holds them against JAX)."""
    _, cfg_t, _, pol_t, _, params_t = models
    cfg = dataclasses.replace(cfg_t, use_rope=False)
    tok = torch.full((1, 1), 7, dtype=torch.int32)
    logits = []
    for p in (0, 5):
        cache = TT.init_cache(cfg, pol_t, 1, 16, device="cpu")
        lt, _ = TT.decode_step(params_t, cfg, pol_t, tok, cache,
                               torch.tensor([p], dtype=torch.int32))
        assert lt.shape == (1, cfg.vocab) and torch.isfinite(lt).all()
        logits.append(lt)
    assert not torch.equal(*logits)
