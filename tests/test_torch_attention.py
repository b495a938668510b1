"""The port's attention outside the serving kernels, and the new model
building blocks, against the JAX package (CPU, plain versions).

* ``flash_attention`` — the plain version of the flash-prefill kernel (the
  port's 64 × 64 tile walk) against JAX ``core.attention.flash_attention``
  (its XLA walk, 512 × 512 chunks) at 2e-2: both round p to bf16 before
  the PV product, but against running maxima of other tiles, so a
  probability may round on the other side of a bf16 tie (≤ 2^-9
  relative), plus one bf16 ulp of the output.  Against the Pallas kernel
  ``ops.flash_prefill_attention`` in interpret mode at JAX's own bar from
  ``test_kernels_flashprefill.py`` (rtol 0.05, atol 0.03), and against the
  f32 oracles (the port's and JAX's ``flash_prefill_ref``) at the same
  bar.  Causal, windowed, non-causal, ragged S, GQA rep 1/2/4, D 64 and
  256.
* ``decode_attention`` / ``cross_attention`` (fused XLA order) against
  JAX's over the same slab bytes, every KV format, at 2e-2.
* ``layer_norm``, ``sinusoidal_pos`` and tanh GELU against JAX's (bit for
  bit where the transcendentals allow it).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import attention as JA
from repro.core import kvcache as JKV
from repro.core import precision as JPR
from repro.kernels import ops as JOPS
from repro.kernels import ref as JREF
from repro.models import common as JC
from repro_torch.convert import to_tensor
from repro_torch.core import attention as TA
from repro_torch.core import kvcache as TKV
from repro_torch.core import precision as TPR
from repro_torch.kernels import ref as TREF
from repro_torch.kernels.flashprefill import flash_prefill
from repro_torch.models import common as TC
from torch_defaults import package_defaults  # noqa: F401

# tiny tensors: one intra-op thread avoids the barrier waits that
# dominate when pytest-xdist workers share the cores
torch.set_num_threads(1)


def _t(a):
    return to_tensor(np.asarray(a), "cpu")


def _f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a, np.float32)


def _qkv(seed, B, S, H, Hkv, D):
    rng = np.random.default_rng(seed)
    return [jnp.asarray(rng.standard_normal((B, S, h, D)) * 0.5,
                        jnp.bfloat16) for h in (H, Hkv, Hkv)]


FLASH_CASES = [
    # B, S, H, Hkv, D, causal, window
    (1, 128, 4, 2, 64, True, None),       # causal, rep 2, two q tiles
    (2, 100, 4, 4, 64, True, None),       # ragged S, rep 1
    (1, 128, 8, 2, 64, True, 40),         # window inside a tile, rep 4
    (1, 96, 4, 1, 64, False, None),       # non-causal (encoder), rep 4
    (1, 77, 4, 1, 256, True, 32),         # recurrentgemma: D 256, MQA
    (1, 50, 2, 2, 256, False, None),      # D 256 non-causal, one ragged tile
]


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_matches_jax(case):
    B, S, H, Hkv, D, causal, window = case
    q, k, v = _qkv(sum(case[:5]), B, S, H, Hkv, D)
    before = flash_prefill.launches
    out_t = TA.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                               window=window)
    assert flash_prefill.launches == before          # plain version on CPU
    out_j = JA.flash_attention(q, k, v, causal=causal, window=window)
    assert out_t.shape == out_j.shape and out_t.dtype == torch.bfloat16
    err = np.abs(_f32(out_t) - _f32(out_j)).max()
    assert err <= 2e-2, err


@pytest.mark.parametrize("case", FLASH_CASES)
def test_flash_attention_matches_pallas_and_oracles(case):
    """The Pallas kernel pads S to its 64-row blocks; the port's walk
    masks the ragged tail instead."""
    B, S, H, Hkv, D, causal, window = case
    q, k, v = _qkv(sum(case[:5]) + 1, B, S, H, Hkv, D)
    out_t = _f32(TA.flash_attention(_t(q), _t(k), _t(v), causal=causal,
                                    window=window))
    pallas = JOPS.flash_prefill_attention(q, k, v, causal=causal,
                                          window=window, block_q=64,
                                          block_k=64)
    for ref in (pallas, JREF.flash_prefill_ref(q, k, v, causal, window),
                TREF.flash_prefill_ref(_t(q), _t(k), _t(v), causal, window)):
        np.testing.assert_allclose(out_t, _f32(ref), rtol=0.05, atol=0.03)


def _head_major(*ts):
    return [_t(a).transpose(1, 2).contiguous() for a in ts]


@pytest.mark.parametrize("chunks", [(16, 128), (32, 256), (128, 128)])
def test_flash_attention_any_tile(chunks):
    """The walk gives the same answer at every tile the kernel takes (a
    skipped tile is an exact no-op), within the tile-order tolerance."""
    q, k, v = _qkv(7, 1, 130, 4, 2, 64)
    base = _f32(TA.flash_attention(_t(q), _t(k), _t(v), window=50))
    out = _f32(flash_prefill(*_head_major(q, k, v), window=50,
                             tile=chunks).transpose(1, 2))
    assert np.abs(out - base).max() <= 2e-2


#: the main path's flash-prefill shapes: (B, H, Hkv, S, D, causal, window)
#: — recurrentgemma-2b's serve prompt and its window-bound length,
#: whisper-tiny's encoder and decoder prompt, whisper-tiny REDUCED's
#: encoder (head dim 32) — and the tile the wrapper picks for each
MAIN_PATH_FLASH = [
    ((1, 10, 1, 127, 256, True, 2048), (64, 64)),
    ((1, 10, 1, 4096, 256, True, 2048), (128, 64)),
    ((1, 6, 6, 1500, 64, False, None), (128, 128)),
    ((1, 6, 6, 15, 64, True, None), (128, 128)),
    ((1, 4, 4, 64, 32, False, None), (16, 128)),
]


@pytest.mark.parametrize("case,tile", MAIN_PATH_FLASH)
def test_flash_tile_choice_at_main_path_shapes(case, tile):
    """The wrapper's tile at each main-path shape is one the kernel takes
    (block_q a multiple of 16 up to 128, block_k one online-softmax
    slice: 128 keys, 64 at D 256), fits in the 227
    KB of shared memory a block may use, and the plain walk at that tile
    matches JAX's ``flash_attention`` at the walk's 2e-2."""
    from repro_torch.kernels import flashprefill as FP
    B, H, Hkv, S, D, causal, window = case
    got = FP.pick_tile(B, H, Hkv, S, D)
    assert got == tile
    FP.check_tile(D, *got)
    assert FP.smem_bytes(D, *got) <= FP.MAX_SMEM
    q, k, v = _qkv(S + D, B, S, H, Hkv, D)
    before = flash_prefill.launches
    out_t = flash_prefill(*_head_major(q, k, v), causal=causal,
                          window=window)
    assert flash_prefill.launches == before          # plain version on CPU
    out_j = JA.flash_attention(q, k, v, causal=causal, window=window)
    err = np.abs(_f32(out_t.transpose(1, 2)) - _f32(out_j)).max()
    assert err <= 2e-2, err


def test_flash_tiles_at_head_dim_288():
    """At gemma3-1b's head dim two warps share each 16-row group and a
    block holds at most 256 threads: row tiles up to 64, one 64-key slice,
    every one inside the 227 KB of shared memory; the training shape (B 2,
    S 2048, 4 heads on 1) takes the 64-row tile; a 128-row tile is
    refused before any launch."""
    from repro_torch.kernels import flashprefill as FP
    assert FP.tiles(288) == [(64, 64), (32, 64), (16, 64)]
    assert all(FP.smem_bytes(288, *t) <= FP.MAX_SMEM for t in FP.tiles(288))
    assert FP.pick_tile(2, 4, 1, 2048, 288) == (64, 64)
    assert FP.pick_tile(1, 4, 1, 20, 288) == (16, 64)
    for t in FP.tiles(288):
        FP.check_tile(288, *t)
    with pytest.raises(ValueError, match="tile"):
        FP.check_tile(288, 128, 64)
    with pytest.raises(ValueError, match="head_dim"):
        FP.check_tile(48, 64, 64)


def test_prefill_attention_oracle_matches_jax():
    q, k, v = _qkv(3, 1, 40, 4, 2, 64)
    for causal, window in ((True, None), (True, 9), (False, None)):
        out_t = TA.prefill_attention(_t(q), _t(k), _t(v), window=window,
                                     causal=causal)
        out_j = JA.prefill_attention(q, k, v, window=window, causal=causal)
        assert np.abs(_f32(out_t) - _f32(out_j)).max() <= 2e-2


@pytest.mark.parametrize("kw", [dict(pos_offset=-4),
                                dict(window=torch.tensor([3, 4])),
                                dict(pos_offset=torch.tensor(2.0))])
def test_flash_attention_outside_contract_raises(kw):
    """A negative offset, and a window or offset that is not an int or a
    0-d integer tensor, are refused (any offset >= 0, Sq != Sk and a 0-d
    window run: ``test_torch_flash_offset.py``)."""
    q = torch.zeros((1, 16, 2, 64), dtype=torch.bfloat16)
    k = torch.zeros((1, 24, 2, 64), dtype=torch.bfloat16)
    with pytest.raises(ValueError):
        TA.flash_attention(q, k, k, **kw)


def _slab_pair(seed, fmt, B, S, Hkv, D, n):
    """A JAX slab holding n random tokens per slot, and the port's view of
    the same bytes."""
    rng = np.random.default_rng(seed)
    spec = JPR.get_policy(f"w4a16{fmt}").kv
    cj = JKV.init_cache(B, S, Hkv, D, spec)
    k = jnp.asarray(rng.standard_normal((B, n, Hkv, D)), jnp.bfloat16)
    v = jnp.asarray(rng.standard_normal((B, n, Hkv, D)), jnp.bfloat16)
    cj = JKV.append(cj, k, v, jnp.int32(0), spec)
    ct = TKV.KVCache(k=_t(cj.k), v=_t(cj.v), k_scale=_t(cj.k_scale[..., 0]),
                     v_scale=_t(cj.v_scale[..., 0]))
    return cj, ct, TPR.get_policy(f"w4a16{fmt}").kv, spec


@pytest.mark.parametrize("fmt", ["kv8", "kv4", "kvfp8", "kv16"])
@pytest.mark.parametrize("T,pos,window", [(1, [9, 3], None), (1, [20, 7], 8),
                                          (3, 5, None)])
def test_decode_attention_matches_jax(fmt, T, pos, window):
    B, S, Hkv, rep, D = 2, 24, 2, 2, 32
    cj, ct, spec_t, spec_j = _slab_pair(T + len(str(pos)), fmt, B, S, Hkv,
                                        D, 24)
    rng = np.random.default_rng(11)
    q = jnp.asarray(rng.standard_normal((B, T, Hkv * rep, D)), jnp.bfloat16)
    pj = jnp.asarray(pos, jnp.int32)
    out_j = JA.decode_attention(q, cj, spec_j, pj, window=window)
    out_t = TA.decode_attention(_t(q), ct, spec_t, torch.tensor(pos),
                                window=window)
    assert out_t.shape == out_j.shape
    assert np.abs(_f32(out_t) - _f32(out_j)).max() <= 2e-2


@pytest.mark.parametrize("fmt", ["kv8", "kv4", "kvfp8", "kv16"])
def test_cross_attention_matches_jax(fmt):
    cj, ct, spec_t, spec_j = _slab_pair(2, fmt, 2, 40, 4, 32, 40)
    q = jnp.asarray(np.random.default_rng(12).standard_normal((2, 3, 4, 32)),
                    jnp.bfloat16)
    out_j = JA.cross_attention(q, cj, spec_j)
    out_t = TA.cross_attention(_t(q), ct, spec_t)
    assert np.abs(_f32(out_t) - _f32(out_j)).max() <= 2e-2


def test_decode_attention_other_impls_raise():
    """``fused`` and ``dequant_first`` are the impls; any other name (the
    JAX package's ``pallas`` is the port's kernel route, not an impl of
    this function) raises."""
    _, ct, spec_t, _ = _slab_pair(0, "kv8", 1, 8, 1, 32, 8)
    with pytest.raises(ValueError, match="unknown impl"):
        TA.decode_attention(torch.zeros((1, 1, 1, 32), dtype=torch.bfloat16),
                            ct, spec_t, 0, impl="pallas")


def test_layer_norm_matches_jax():
    """bf16 in and out: the f32 statistics differ by ulps in summation
    order, which the bf16 output rounding hides (bit for bit here), and in
    f32 within 1e-5 relative."""
    rng = np.random.default_rng(4)
    x = rng.standard_normal((3, 7, 384)).astype(np.float32) * 3 + 1
    g = rng.standard_normal(384).astype(np.float32)
    b = rng.standard_normal(384).astype(np.float32)
    for dt in (jnp.bfloat16, jnp.float32):
        args = [jnp.asarray(a, dt) for a in (x, g, b)]
        nj = _f32(JC.layer_norm(*args))
        nt = _f32(TC.layer_norm(*[_t(a) for a in args]))
        if dt == jnp.bfloat16:
            np.testing.assert_array_equal(nt, nj)
        else:
            np.testing.assert_allclose(nt, nj, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("S,D,offset", [(1500, 384, 0), (64, 128, 0),
                                        (16, 64, 7)])
def test_sinusoidal_pos_matches_jax(S, D, offset):
    """bf16 tables equal bit for bit except where XLA's f32 exp and sin
    (a few ulps off the correctly rounded value at angles up to ~1500 rad)
    push a value across a bf16 rounding boundary: there one bf16 ulp
    (2^-8 at |x| < 1), at under 0.1 % of the entries (0.047 % measured at
    1500 x 384)."""
    pj = _f32(JC.sinusoidal_pos(S, D, offset))
    pt = TC.sinusoidal_pos(S, D, offset)
    assert pt.dtype == torch.bfloat16 and pt.shape == (S, D)
    diff = np.abs(_f32(pt) - pj)
    assert diff.max() <= 2 ** -8 and (diff > 0).mean() < 1e-3


def test_gelu_is_jax_tanh_gelu():
    x = np.linspace(-6, 6, 4001, dtype=np.float32)
    gj = np.asarray(jax.nn.gelu(jnp.asarray(x)))
    gt = TC.gelu(torch.from_numpy(x)).numpy()
    np.testing.assert_allclose(gt, gj, rtol=1e-6, atol=1e-6)
    exact = torch.nn.functional.gelu(torch.from_numpy(x)).numpy()
    assert np.abs(exact - gj).max() > 1e-4           # the form matters
