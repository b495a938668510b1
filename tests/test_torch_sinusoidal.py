"""Sinusoidal positions (``use_rope=False``) in the dense family's
``prefill`` and ``decode_step``, against the JAX package.

smollm-360m REDUCED with ``use_rope=False``, the same parameters in both
packages (``params_from_jax``, each package's own packer), w4a16kv8:

* ``prefill`` of 12 tokens on two slots: JAX jitted (its XLA flash walk),
  the port on the CPU (the flash-prefill kernel's plain version).
* ``decode_step`` teacher-forced on the dense slab and on the paged pool
  (a shuffled block table): a ragged 8-token chunk, a second chunk, then
  a mixed step at the end of the context — slot 0 feeds its last two
  positions in a 4-row step, so its two padding rows lie past the
  position table (``n_ctx`` = 16: the slab's length, the block table's
  width × block size), and slot 1 idles.  JAX jitted with its fused
  attention.  Logits within 2e-2 · max |logit| of JAX's for every slot
  that emits, top-1 equal where JAX's margin is clear.
* The port's dense and paged steps give the same logits bit for bit (the
  slab walked in the pool's 8-token tiles, as the engine sets it).
* The table rows themselves: a per-slot gather equals JAX's ``take`` on
  every row inside the table (within one bf16 ulp: the two libraries'
  f32 sines may round differently); JAX fills rows past the table with
  NaN, the port reads the table's last row there (such rows are padding:
  neither written to the cache nor read for logits).  A scalar position
  whose rows would run past the table reads, as ``dynamic_slice`` does,
  the last T rows.
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
from repro_torch.configs import get_reduced as t_reduced
from repro_torch.convert import params_from_jax, to_tensor
from repro_torch.core.precision import get_policy as t_policy
from repro_torch.models import transformer as TT
from repro_torch.serving.engine import quantize_params as t_quantize
from torch_defaults import package_defaults  # noqa: F401

torch.set_num_threads(1)

TOL = 2e-2
POLICY = "w4a16kv8"
N_SLOTS, N_BLOCKS, BS, BPS = 2, 6, 8, 2
N_CTX = BS * BPS
#: (first positions, valid rows, T) of the teacher-forced steps
STEPS = [([0, 0], [8, 6], 8), ([8, 6], [6, 8], 8), ([14, 0], [2, 0], 4)]


@pytest.fixture(scope="module")
def models():
    cfg_j = dataclasses.replace(j_reduced("smollm-360m"), use_rope=False)
    cfg_t = dataclasses.replace(t_reduced("smollm-360m"), use_rope=False)
    raw_j = JT.init_params(cfg_j, jax.random.PRNGKey(3))
    pol_j, pol_t = j_policy(POLICY), t_policy(POLICY)
    params_t = t_quantize(params_from_jax(jax.device_get(raw_j), cfg_t,
                                          device="cpu"), pol_t)
    return cfg_j, cfg_t, pol_j, pol_t, j_quantize(raw_j, pol_j), params_t


def _np(x):
    return to_tensor(np.asarray(x), "cpu").float().numpy()


def _close(lt, lj, rows):
    lt, lj = lt[rows], lj[rows]
    assert np.isfinite(lt).all()
    scale = np.abs(lj).max()
    assert np.abs(lt - lj).max() <= TOL * scale
    top2 = np.sort(lj, axis=-1)[:, -2:]
    clear = (top2[:, 1] - top2[:, 0]) > TOL * scale
    np.testing.assert_array_equal(lt.argmax(-1)[clear], lj.argmax(-1)[clear])


def test_prefill_matches_jax(models):
    cfg_j, cfg_t, pol_j, pol_t, params_j, params_t = models
    toks = np.random.default_rng(0).integers(1, cfg_t.vocab, (2, 12))
    prefill_j = jax.jit(JT.prefill, static_argnames=("cfg", "policy"))
    lj, _ = prefill_j(params_j, cfg_j, pol_j, jnp.asarray(toks, jnp.int32),
                      JT.init_cache(cfg_j, pol_j, 2, 16))
    lt, _ = TT.prefill(params_t, cfg_t, pol_t, torch.from_numpy(toks),
                       TT.init_cache(cfg_t, pol_t, 2, 16, device="cpu"))
    _close(lt.float().numpy(), _np(lj), [0, 1])
    # the positions are in: the same tokens in another order differ
    lt2, _ = TT.prefill(params_t, cfg_t, pol_t,
                        torch.from_numpy(toks[:, ::-1].copy()),
                        TT.init_cache(cfg_t, pol_t, 2, 16, device="cpu"))
    assert not torch.equal(lt, lt2)


def _caches(cfg_j, cfg_t, pol_j, pol_t, kind):
    tbl = np.array([[4, 1], [0, 5]], np.int32)
    if kind == "paged":
        cj = JT.init_paged_cache(cfg_j, pol_j, N_SLOTS, N_BLOCKS, BS, BPS)
        cj = dataclasses.replace(cj, block_table=jnp.broadcast_to(
            jnp.asarray(tbl), cj.block_table.shape))
        ct = TT.init_paged_cache(cfg_t, pol_t, N_SLOTS, N_BLOCKS, BS, BPS,
                                 device="cpu")
        ct.block_table.copy_(torch.from_numpy(tbl))
        return cj, ct
    return (JT.init_cache(cfg_j, pol_j, N_SLOTS, N_CTX),
            TT.init_cache(cfg_t, pol_t, N_SLOTS, N_CTX, device="cpu"))


def _run_steps(models, kind):
    """Both packages through STEPS; returns the port's logits per step."""
    cfg_j, cfg_t, pol_j, pol_t, params_j, params_t = models
    cache_j, cache_t = _caches(cfg_j, cfg_t, pol_j, pol_t, kind)
    step_j = jax.jit(JT.decode_step, static_argnames=("cfg", "policy"))
    stream = np.random.default_rng(1).integers(1, cfg_t.vocab,
                                               (N_SLOTS, N_CTX + 4))
    out = []
    for pos, valid, T in STEPS:
        toks = np.stack([stream[b, pos[b]:pos[b] + T] for b in range(2)])
        pos, valid = np.array(pos, np.int32), np.array(valid, np.int32)
        lj, cache_j = step_j(params_j, cfg_j, pol_j, jnp.asarray(toks),
                             cache_j, jnp.asarray(pos),
                             valid=jnp.asarray(valid))
        # the engine's knobs: both backends walk 8-token tiles
        kw = (dict(max_live=N_CTX) if kind == "paged"
              else dict(attn_block_s=BS))
        lt, cache_t = TT.decode_step(params_t, cfg_t, pol_t,
                                     torch.from_numpy(toks), cache_t,
                                     torch.from_numpy(pos),
                                     valid=torch.from_numpy(valid), **kw)
        _close(lt.float().numpy(), _np(lj), valid > 0)
        out.append(lt)
    return out


@pytest.mark.parametrize("kind", ["dense", "paged"])
def test_decode_step_matches_jax(models, kind):
    _run_steps(models, kind)


def test_dense_equals_paged_bitwise(models):
    for ld, lp in zip(_run_steps(models, "dense"),
                      _run_steps(models, "paged")):
        assert torch.equal(ld, lp)


def test_position_rows_against_jax_table():
    d, T = 64, 4
    sp_j = JC.sinusoidal_pos(N_CTX, d)
    pos = np.array([3, N_CTX - 2], np.int32)
    idx = pos[:, None] + np.arange(T)[None]
    rows_j = _np(jnp.take(sp_j, jnp.asarray(idx), axis=0))
    rows_t = TT._position_rows(N_CTX, d, torch.from_numpy(pos), T,
                               per_slot=True).float().numpy()
    inside = idx < N_CTX
    np.testing.assert_allclose(rows_t[inside], rows_j[inside], rtol=0,
                               atol=2 ** -8)
    assert np.isnan(rows_j[~inside]).all()           # the reference's fill
    np.testing.assert_array_equal(
        rows_t[~inside], np.broadcast_to(rows_t[1, 1], rows_t[~inside].shape))
    # a scalar position: dynamic_slice clamps the start to fit the table
    sl_j = _np(jax.lax.dynamic_slice_in_dim(sp_j, N_CTX - 2, T))
    sl_t = TT._position_rows(N_CTX, d, torch.full((2,), N_CTX - 2), T,
                             per_slot=False).float().numpy()
    for b in range(2):
        np.testing.assert_allclose(sl_t[b], sl_j, rtol=0, atol=2 ** -8)
