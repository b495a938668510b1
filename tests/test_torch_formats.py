"""The port's formats equal the JAX package's bit for bit.

Same numpy inputs through ``repro.core`` (under ``jax.jit``, as the JAX
engine runs it — see ``repro_torch/core/quantize.py`` on why eager JAX
differs in the last bit of some scales) and ``repro_torch.core``:
quantized integers, f32 scales (compared as bit patterns), per-token
activation quantization, nibble order, tile-major packed bytes, the
block-table scatter of ``append_paged`` (valid mask, sentinel table
entries, idle slots) and the dense slab's ``append`` / ``append_per_slot``
(valid mask, rows past the slab dropped), for every KV format.
Tolerance: none — every comparison is exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import kvcache as JKV
from repro.core import packing as JP
from repro.core import paged_kvcache as JPKV
from repro.core import precision as JPR
from repro.core import quantize as JQ
from repro_torch.convert import to_tensor
from repro_torch.core import kvcache as TKV
from repro_torch.core import packing as TP
from repro_torch.core import paged_kvcache as TPKV
from repro_torch.core import precision as TPR
from repro_torch.core import quantize as TQ

# tiny tensors: one intra-op thread avoids the barrier waits that
# dominate when pytest-xdist workers share the cores
torch.set_num_threads(1)


def _np(t):
    """torch or JAX array → numpy, f32 as uint32 bits (bitwise compare)."""
    a = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _bits(t):
    """Quantized KV of any storage dtype → its raw bytes."""
    if isinstance(t, torch.Tensor):
        return t.contiguous().view(torch.uint8).numpy()
    a = np.ascontiguousarray(np.asarray(t))
    return a.view(np.uint8)


def _bf16(rng, shape, scale=1.0):
    """bf16-representable f32 values (what the engine quantizes)."""
    x = rng.standard_normal(shape).astype(np.float32) * scale
    return torch.from_numpy(x).to(torch.bfloat16).float().numpy()


@pytest.mark.parametrize("fmt", ["w4a16kv8", "w8a16kv4", "wfp8afp8kvfp8",
                                 "w16a16kv16", "qserve", "default"])
def test_policy_parse_and_qmax(fmt):
    j, t = JPR.get_policy(fmt), TPR.get_policy(fmt)
    assert t.name == j.name
    for a in ("weights", "acts", "kv"):
        fj, ft = getattr(j, a), getattr(t, a)
        assert (ft.name, ft.bits, ft.packed, ft.is_float) == \
            (fj.name, fj.bits, fj.packed, fj.is_float)
        assert ft.qmax == fj.qmax
        assert str(ft.dtype).split(".")[-1] == np.dtype(fj.dtype).name


@pytest.mark.parametrize("bits,group", [(4, 64), (4, 128), (8, 32), (4, 32)])
def test_quantize_weight_grouped_bitwise(bits, group):
    w = _bf16(np.random.default_rng(bits * group), (256, 96))
    qj, sj = jax.jit(JQ.quantize_weight_grouped, static_argnums=(1, 2))(
        jnp.asarray(w), bits, group)
    qt, st = TQ.quantize_weight_grouped(torch.from_numpy(w), bits, group)
    np.testing.assert_array_equal(_np(qt), _np(qj))
    np.testing.assert_array_equal(_np(st), _np(sj))


def test_round_half_even_ties():
    """Exact .5 quotients round to even in both packages."""
    x = np.array([0.5, 1.5, 2.5, -0.5, -2.5, 3.5, 200.0], np.float32)
    qj = JQ.quantize_int(jnp.asarray(x), jnp.float32(1.0), 8)
    qt = TQ.quantize_int(torch.from_numpy(x), torch.ones(()), 8)
    np.testing.assert_array_equal(_np(qt), _np(qj))
    assert list(_np(qt)) == [0, 2, 2, 0, -2, 4, 127]


@pytest.mark.parametrize("axis", [0, 1, 2])
def test_pack_unpack_int4_bitwise(axis):
    q = np.random.default_rng(axis).integers(-8, 8, (6, 8, 4)).astype(np.int8)
    pj = JQ.pack_int4(jnp.asarray(q), axis=axis)
    pt = TQ.pack_int4(torch.from_numpy(q), dim=axis)
    np.testing.assert_array_equal(_np(pt), _np(pj))
    np.testing.assert_array_equal(_np(TQ.unpack_int4(pt, dim=axis)), q)


# every (bk, bn) pick_blocks gives smollm-360m (full and reduced)
TILES = [(64, 96), (64, 64), (64, 128), (32, 96), (128, 64)]


@pytest.mark.parametrize("bk,bn", TILES)
def test_pack_weight_bitwise(bk, bn):
    w = _bf16(np.random.default_rng(bk + bn), (3 * bk, 2 * bn), 0.05)
    pj = JP.pack_weight(jnp.asarray(w), bits=4, group=bk, block_k=bk,
                        block_n=bn)
    pt = TP.pack_weight(torch.from_numpy(w), bits=4, group=bk, block_k=bk,
                        block_n=bn)
    np.testing.assert_array_equal(_np(pt.data), _np(pj.data))
    np.testing.assert_array_equal(_np(pt.scales), _np(pj.scales))
    np.testing.assert_array_equal(_np(TP.unpack_weight(pt)),
                                  _np(JP.unpack_weight(pj)))
    np.testing.assert_array_equal(
        _np(TP.dequantize_packed(pt, torch.float32)),
        _np(JP.dequantize_packed(pj, jnp.float32)))


def _pick_block_tiles():
    """Every (bk, bn) ``pick_blocks`` gives a packed GEMM weight of
    smollm-360m, recurrentgemma-2b and whisper-tiny (full widths)."""
    from repro_torch.configs import get_config
    from repro_torch.models.common import pick_blocks
    tiles = set()
    for arch in ("smollm-360m", "recurrentgemma-2b", "whisper-tiny"):
        c = get_config(arch)
        d, hd = c.d_model, c.d_model // c.n_heads
        for K, N in ((d, c.n_heads * hd), (d, c.n_kv_heads * hd),
                     (c.n_heads * hd, d), (d, c.d_ff), (c.d_ff, d)):
            tiles.add(pick_blocks(K, N))
    return sorted(tiles)


FRAG_TILES = _pick_block_tiles()


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("bk,bn", FRAG_TILES)
def test_kernel_layout_bitwise(bk, bn, bits):
    """Both CUDA kernels' fragment orders are exact permutations: each
    round-trips (tile-major → fragment order → values equal the JAX
    package's ``unpack_weight`` and ``dequantize_packed`` bit for bit)."""
    w = _bf16(np.random.default_rng(bk * bn + bits), (256, 2 * bn), 0.05)
    pj = JP.pack_weight(jnp.asarray(w), bits=bits, group=bk, block_k=bk,
                        block_n=bn)
    pt = TP.pack_weight(torch.from_numpy(w), bits=bits, group=bk,
                        block_k=bk, block_n=bn)
    for kernel in ("a16", "a8"):
        pf = TP.to_kernel_layout(pt, kernel)
        assert pf.layout == f"frag_{kernel}" and tuple(pf.data.shape) == \
            (2 * bn // 16, 256 // 64, 32, 4 * bits)
        np.testing.assert_array_equal(_np(TP.unpack_weight(pf)),
                                      _np(JP.unpack_weight(pj)))
        np.testing.assert_array_equal(
            _np(TP.dequantize_packed(pf, torch.float32)),
            _np(JP.dequantize_packed(pj, jnp.float32)))


@pytest.mark.parametrize("kernel", ["a16", "a8"])
def test_kernel_layout_needs_k_multiple_of_64(kernel):
    """A K of 32 times an odd number packs on the CPU at block_k 32 (as in
    the JAX package), but has no fragment layout: the CUDA GEMMs read K
    in 64-deep chunks, and the error says so."""
    from repro_torch.models.common import maybe_quantize
    w = torch.from_numpy(_bf16(np.random.default_rng(5), (288, 256), 0.05))
    pt = maybe_quantize(w, TPR.get_policy("w4a16kv8"))
    assert pt.layout == "tile" and pt.block_k == 32
    with pytest.raises(ValueError, match=r"K % 64 == 0.*block_k 32"):
        TP.to_kernel_layout(pt, kernel)


@pytest.mark.parametrize("fmt", ["kv8", "kv4", "kvfp8", "kv16"])
def test_quantize_kv_bitwise(fmt):
    x = _bf16(np.random.default_rng(3), (2, 5, 3, 64), 2.0)
    spec_j = JPR.get_policy(f"w4a16{fmt}").kv
    spec_t = TPR.get_policy(f"w4a16{fmt}").kv
    qj, sj = jax.jit(JQ.quantize_kv, static_argnums=1)(
        jnp.asarray(x).astype(jnp.bfloat16), spec_j)
    qt, st = TQ.quantize_kv(torch.from_numpy(x).to(torch.bfloat16), spec_t)
    np.testing.assert_array_equal(_bits(qt), _bits(qj))
    np.testing.assert_array_equal(_np(st), _np(sj))
    np.testing.assert_array_equal(
        _np(TQ.dequantize_kv(qt, st, spec_t, torch.float32)),
        _np(JQ.dequantize_kv(qj, sj, spec_j, jnp.float32)))


def test_append_paged_pool_bitwise():
    """Two ragged appends through a table with sentinel entries, an idle
    slot and a valid mask: pool bytes and scales equal JAX's."""
    B, nb, bs, H, D, bps = 3, 10, 4, 2, 32, 4
    spec_j = JPR.get_policy("w4a16kv8").kv
    spec_t = TPR.get_policy("w4a16kv8").kv
    tbl = np.array([[7, 2, nb, nb], [0, 5, 9, 1], [nb] * 4], np.int32)
    cj = JPKV.init_paged(B, nb, bs, H, D, spec_j, blocks_per_slot=bps)
    cj = dataclasses.replace(cj, block_table=jnp.asarray(tbl))
    ct = TPKV.init_paged(B, nb, bs, H, D, spec_t, bps, device="cpu")
    ct.block_table.copy_(torch.from_numpy(tbl))
    lt = ct.layer(0)
    rng = np.random.default_rng(11)
    steps = [(6, [5, 5, 0], [6, 3, 0]),      # slot 0 runs into a sentinel
             (2, [0, 8, 3], [2, 2, 1])]
    append_j = jax.jit(JPKV.append_paged, static_argnames=("spec",))
    for T, pos, valid in steps:
        k = _bf16(rng, (B, T, H, D))
        v = _bf16(rng, (B, T, H, D))
        cj = append_j(
            cj, jnp.asarray(k).astype(jnp.bfloat16),
            jnp.asarray(v).astype(jnp.bfloat16), jnp.asarray(pos, jnp.int32),
            spec=spec_j, valid=jnp.asarray(valid, jnp.int32))
        TPKV.append_paged(lt, torch.from_numpy(k).to(torch.bfloat16),
                          torch.from_numpy(v).to(torch.bfloat16),
                          torch.tensor(pos, dtype=torch.int32), spec_t,
                          valid=torch.tensor(valid, dtype=torch.int32))
    np.testing.assert_array_equal(_np(lt.k), _np(cj.k))
    np.testing.assert_array_equal(_np(lt.v), _np(cj.v))
    np.testing.assert_array_equal(_np(lt.k_scale), _np(cj.k_scale[..., 0]))
    np.testing.assert_array_equal(_np(lt.v_scale), _np(cj.v_scale[..., 0]))


ALL_POLICIES = [w + a + kv for w in ("w4", "w8", "wfp8", "w16")
                for a in ("a8", "afp8", "a16")
                for kv in ("kv4", "kv8", "kvfp8", "kv16")]


@pytest.mark.parametrize("fmt", ALL_POLICIES)
def test_int8_matmul_route_matches(fmt):
    """Which GEMM a policy takes: integer weights × int8 activations only
    (afp8 activations are never quantized)."""
    t = TPR.get_policy(fmt)
    assert t.int8_matmul == JPR.get_policy(fmt).int8_matmul
    assert t.int8_matmul == (fmt[:2] in ("w4", "w8") and "a8" in fmt
                             and "afp8" not in fmt)


@pytest.mark.parametrize("shape", [(5, 320), (2, 3, 960), (1, 64)])
def test_quantize_act_per_token_bitwise(shape):
    x = _bf16(np.random.default_rng(len(shape)), shape, 3.0)
    x[..., 0, :] = 0.0                        # an all-zero token row
    qj, sj = jax.jit(JQ.quantize_act_per_token, static_argnums=1)(
        jnp.asarray(x), 8)
    qt, st = TQ.quantize_act_per_token(torch.from_numpy(x), 8)
    np.testing.assert_array_equal(_np(qt), _np(qj))
    np.testing.assert_array_equal(_np(st), _np(sj))


def _kv_state(c, j):
    """A KV store's quantized bytes and scale bits: port (scales (..., H))
    or JAX (scales (..., H, 1))."""
    if j:
        return [_bits(c.k), _bits(c.v), _np(c.k_scale[..., 0]),
                _np(c.v_scale[..., 0])]
    return [_bits(c.k), _bits(c.v), _np(c.k_scale), _np(c.v_scale)]


@pytest.mark.parametrize("fmt", ["kv8", "kv4", "kvfp8", "kv16"])
def test_append_dense_bitwise(fmt):
    """Ragged per-slot appends (a valid mask, an idle slot, a slot running
    past the slab), then an aligned append clamped at the slab's end: slab
    bytes and scales equal JAX's."""
    B, S, H, D = 3, 12, 2, 32
    spec_j = JPR.get_policy(f"w4a16{fmt}").kv
    spec_t = TPR.get_policy(f"w4a16{fmt}").kv
    cj = JKV.init_cache(B, S, H, D, spec_j)
    ct = TKV.init_cache(B, S, H, D, spec_t, device="cpu").layer(0)
    rng = np.random.default_rng(12)
    per_slot = jax.jit(JKV.append_per_slot, static_argnames=("spec",))
    for T, pos, valid in ((6, [0, 9, 2], [6, 5, 0]),
                          (3, [6, 11, 2], [2, 3, 3])):
        k, v = _bf16(rng, (B, T, H, D)), _bf16(rng, (B, T, H, D))
        cj = per_slot(cj, jnp.asarray(k).astype(jnp.bfloat16),
                      jnp.asarray(v).astype(jnp.bfloat16),
                      jnp.asarray(pos, jnp.int32), spec=spec_j,
                      valid=jnp.asarray(valid, jnp.int32))
        TKV.append_per_slot(ct, torch.from_numpy(k).to(torch.bfloat16),
                            torch.from_numpy(v).to(torch.bfloat16),
                            torch.tensor(pos, dtype=torch.int32), spec_t,
                            valid=torch.tensor(valid, dtype=torch.int32))
    k, v = _bf16(rng, (B, 4, H, D)), _bf16(rng, (B, 4, H, D))
    cj = jax.jit(JKV.append, static_argnames=("spec",))(
        cj, jnp.asarray(k).astype(jnp.bfloat16),
        jnp.asarray(v).astype(jnp.bfloat16), jnp.int32(10), spec=spec_j)
    TKV.append(ct, torch.from_numpy(k).to(torch.bfloat16),
               torch.from_numpy(v).to(torch.bfloat16), 10, spec_t)
    for a, b in zip(_kv_state(ct, False), _kv_state(cj, True)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("fmt", ["kv4", "kvfp8", "kv16"])
def test_append_paged_other_formats_bitwise(fmt):
    B, nb, bs, H, D, bps = 2, 6, 4, 2, 32, 3
    spec_j = JPR.get_policy(f"w4a16{fmt}").kv
    spec_t = TPR.get_policy(f"w4a16{fmt}").kv
    tbl = np.array([[4, 1, nb], [0, 5, 2]], np.int32)
    cj = JPKV.init_paged(B, nb, bs, H, D, spec_j, blocks_per_slot=bps)
    cj = dataclasses.replace(cj, block_table=jnp.asarray(tbl))
    ct = TPKV.init_paged(B, nb, bs, H, D, spec_t, bps, device="cpu")
    ct.block_table.copy_(torch.from_numpy(tbl))
    rng = np.random.default_rng(13)
    k, v = _bf16(rng, (B, 10, H, D)), _bf16(rng, (B, 10, H, D))
    pos, valid = [0, 1], [10, 7]
    cj = jax.jit(JPKV.append_paged, static_argnames=("spec",))(
        cj, jnp.asarray(k).astype(jnp.bfloat16),
        jnp.asarray(v).astype(jnp.bfloat16), jnp.asarray(pos, jnp.int32),
        spec=spec_j, valid=jnp.asarray(valid, jnp.int32))
    TPKV.append_paged(ct.layer(0), torch.from_numpy(k).to(torch.bfloat16),
                      torch.from_numpy(v).to(torch.bfloat16),
                      torch.tensor(pos, dtype=torch.int32), spec_t,
                      valid=torch.tensor(valid, dtype=torch.int32))
    for a, b in zip(_kv_state(ct.layer(0), False), _kv_state(cj, True)):
        np.testing.assert_array_equal(a, b)


def test_bf16_carry_across():
    """JAX bf16 numpy arrays (ml_dtypes) cross by bit pattern."""
    a = np.asarray(jnp.asarray([1.5, -2.25, 3e-3], jnp.bfloat16))
    t = to_tensor(a, "cpu")
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(), a.astype(np.float32))


def test_allocator_reservation_invariants():
    al = TPKV.BlockAllocator(4)
    got = al.alloc(3)
    assert got == [0, 1, 2] and al.available == 1
    with pytest.raises(TPKV.OutOfBlocksError):
        al.alloc(2)
    al.free(got[:1])
    with pytest.raises(ValueError):
        al.free(got[:1])                      # double free
    assert al.available == 2 and al.peak_live == 3
