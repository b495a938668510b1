"""The port's formats equal the JAX package's bit for bit.

Same numpy inputs through ``repro.core`` (under ``jax.jit``, as the JAX
engine runs it — see ``repro_torch/core/quantize.py`` on why eager JAX
differs in the last bit of some scales) and ``repro_torch.core``:
quantized integers, f32 scales (compared as bit patterns), nibble order,
tile-major packed bytes and the block-table scatter of ``append_paged``
(valid mask, sentinel table entries, idle slots).  Tolerance: none — every
comparison is exact.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import packing as JP
from repro.core import paged_kvcache as JPKV
from repro.core import precision as JPR
from repro.core import quantize as JQ
from repro_torch.convert import to_tensor
from repro_torch.core import packing as TP
from repro_torch.core import paged_kvcache as TPKV
from repro_torch.core import precision as TPR
from repro_torch.core import quantize as TQ


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
