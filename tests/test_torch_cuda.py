"""CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test takes the ``dev`` fixture, which skips when no
CUDA device is present (this file imports nothing of JAX, so it also runs
on a machine without it: ``python -m pytest --noconftest -q
tests/test_torch_cuda.py``).

Tolerances:

* GEMMs — kernel and plain version multiply the same bf16 weights (A16)
  or the same integers with exact s32 group partials (A8) and accumulate
  in f32, in different orders; after the bf16 output rounding they may
  differ by one bf16 ulp: |Δ| ≤ 2^-7 · max|y|.  The kernels take the
  weights in their fragment order (``to_kernel_layout``); a row's bits do
  not depend on M (the K split is fixed by the weight's shape).
* Attention — same rounding points, but the kernel sums its dots on the
  tensor cores and walks the tiles in eight splits (tile s in split
  s % 8) combined at the end, where the plain version walks them in one
  order: p rounds to bf16 against another running max, so a weight may
  round on the other side of a tie, plus one bf16 ulp of the output:
  |Δ| ≤ 2^-6 · max|plain| (two bf16 ulps of the largest output).  q is
  4 · N(0, 1) against unit-variance keys (scores of std 4), so a few keys
  carry each row and a dropped tile, split or window edge moves the
  output by O(1).
* Dense ≡ paged, batch-mates, n_live and chunking: the split depends on
  the logical tile index only, so these are compared bit for bit.
* MoE — the layer on the card against the same call on the CPU: the
  router's bf16 logits may differ by an ulp, so a token may take another
  expert, but only at a near-tie (router probabilities within 4e-3,
  ``test_torch_moe``'s A16 bar); the other tokens' outputs, bf16 matmuls
  summed in other orders, within 2e-2 · max|y|.
* Flash prefill — the kernel against its plain version (the same tile
  walk, ``ref.flash_prefill_walk``): the same rounding points, dot
  products summed in other orders (tensor-core fragments against
  PyTorch's matmul), so p may round to bf16 on the other side of a tie,
  plus one bf16 ulp of the output: |Δ| ≤ 2^-6 · max|plain| (two bf16
  ulps of the largest output), on inputs whose scores single out a few
  keys per row so a mask or window error moves the output by O(1).  The
  lse it writes for training against the walk's at 1e-5 relative (one
  f32 ulp of m + log l, sums in other orders), and the output with the
  lse written is the output without it, bit for bit.
* Flash prefill's backward — the kernels against
  ``ref.flash_prefill_bwd_ref`` (the same math and bf16 rounding points
  of P and dS, f32 sums in other orders, so a P or dS may round to the
  other side of a bf16 tie): |Δ| ≤ 2e-2 · max|plain| per gradient; the
  gradients repeat bit for bit (no atomics; split walks' partials summed
  in a fixed order).
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import kvcache as KV
from repro_torch.core import paged_kvcache as PKV
from repro_torch.core import quantize as Q
from repro_torch.core.packing import pack_weight, to_kernel_layout
from repro_torch.core.precision import get_policy
from repro_torch.kernels import ref
from repro_torch.kernels.flashprefill import (flash_prefill,
                                              flash_prefill_bwd, tiles)
from repro_torch.kernels.kvattn import kvattn
from repro_torch.kernels.mpgemm import mpgemm_a16, mpgemm_int8
from repro_torch.kernels.paged_kvattn import paged_kvattn

pytestmark = pytest.mark.cuda

FORMATS = ("kv8", "kv4", "kvfp8", "kv16")


def spec_of(fmt):
    return get_policy(f"w4a16{fmt}").kv


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _garbage(store, spec, rng, D):
    """Fill every cell of a per-layer KV store with finite values stored in
    ``spec`` (what stale slots and unmapped blocks hold)."""
    for buf, sc in ((store.k, store.k_scale), (store.v, store.v_scale)):
        x = torch.from_numpy(rng.standard_normal(
            tuple(sc.shape) + (D,), np.float32)).to(buf.device)
        q, s = Q.quantize_kv(x.to(torch.bfloat16), spec)
        buf.copy_(q)
        sc.copy_(s[..., 0])


def _tokens(rng, n, Hkv, D, device):
    return torch.from_numpy(rng.standard_normal((1, n, Hkv, D), np.float32)
                            ).to(device, torch.bfloat16)


def paged_case(seed, fmt, B, Hkv, D, bs, bps, lengths, device, k_shift=0.0):
    """A per-layer pool holding ``lengths[b]`` random tokens for slot b
    (keys offset by ``k_shift``) through a shuffled block table (sentinel
    tail), every other pool cell filled with finite garbage; and the same
    tokens, written the same way, in a dense slab of ``bps * bs`` tokens
    per slot."""
    spec = spec_of(fmt)
    rng = np.random.default_rng(seed)
    nb = B * bps + 3
    layer = PKV.init_paged(B, nb, bs, Hkv, D, spec, bps,
                           device=device).layer(0)
    slab = KV.init_cache(B, bps * bs, Hkv, D, spec, device=device).layer(0)
    _garbage(layer, spec, rng, D)
    _garbage(slab, spec, rng, D)
    order = rng.permutation(nb)
    tbl = np.full((B, bps), nb, np.int32)
    nxt = 0
    for b, n in enumerate(lengths):
        need = PKV.blocks_needed(n, bs)
        tbl[b, :need] = order[nxt:nxt + need]
        nxt += need
    layer.block_table.copy_(torch.from_numpy(tbl))
    zero = torch.zeros(1, dtype=torch.int32, device=device)
    for b, n in enumerate(lengths):
        k = _tokens(rng, n, Hkv, D, device) + k_shift
        v = _tokens(rng, n, Hkv, D, device)
        row = dataclasses.replace(layer, block_table=layer.block_table[b:b + 1])
        PKV.append_paged(row, k, v, zero, spec)
        KV.append_per_slot(KV.KVCache(slab.k[b:b + 1], slab.v[b:b + 1],
                                      slab.k_scale[b:b + 1],
                                      slab.v_scale[b:b + 1]),
                           k, v, zero, spec)
    return layer, slab


ATTN_CASES = [
    # B, Hkv, rep, D, bs, bps, pos, T, window, n_live
    (4, 5, 3, 64, 16, 16, [63, 36, 99, 0], 1, None, None),     # full decode
    (4, 5, 3, 64, 16, 16, [32, 0, 64, 96], 32, None, None),    # full chunk
    (2, 5, 1, 64, 8, 4, [4, 0], 4, None, 2),                  # reduced
    (2, 2, 2, 32, 4, 8, [9, 17], 4, 6, None),                  # window
    (2, 2, 2, 32, 8, 8, [36, 19], 4, None, 6),                 # live-bounded
    (3, 2, 4, 128, 64, 2, [70, 5, 127], 1, None, None),        # wide tiles
    (2, 2, 2, 32, 4, 32, [97, 60], 1, None, None),             # 25 tiles:
    #                               every split walks two to four of them
    (4, 2, 3, 64, 8, 16, [3, 21, 50, 77], 1, None, None),      # frontiers in
    #                               splits 0, 2, 6 and 1 of one batch
    (2, 2, 2, 32, 8, 16, [90, 45], 4, 37, None),               # window edge
    #                               inside a split, several splits live
    # gemma3-1b's heads (D 288, 4 query heads on 1 KV head) and window
    (4, 1, 4, 288, 16, 96, [1100, 1030, 1499, 37], 1, 1024, None),  # the
    #                               window cuts three of the four contexts
    (4, 1, 4, 288, 16, 96, [1100, 1030, 1499, 37], 1, None, None),  # global
    (4, 1, 4, 288, 16, 96, [1010, 0, 1400, 1020], 32, 1024, None),  # chunks
    #                               whose rows straddle the window's edge
]
#: the D 288 chunk case of ATTN_CASES
WIDE_CHUNK_CASE = ATTN_CASES[-1]

#: decode attention's bar against its plain version: two bf16 ulps of the
#: largest output (see the module docstring)
ATTN_REL_TOL = 2 ** -6


def _attn_inputs(case, fmt, dev, shift=0.0):
    """Peaked inputs: q ~ 4 N(0, 1) against keys of unit variance (scores
    of std 4), so a few keys carry each row.  ``shift`` offsets q by
    -shift and the keys by +shift in every element."""
    B, Hkv, rep, D, bs, bps, pos, T, window, n_live = case
    layer, slab = paged_case(0, fmt, B, Hkv, D, bs, bps,
                             [p + T for p in pos], dev, k_shift=shift)
    rng = np.random.default_rng(1)
    q = torch.from_numpy(4 * rng.standard_normal(
        (B, Hkv, T * rep, D), np.float32) - shift).to(dev, torch.bfloat16)
    posd = torch.tensor(pos, dtype=torch.int32, device=dev)
    win = ref.NO_WINDOW if window is None else window
    nl = bps if n_live is None else n_live
    return layer, slab, q, posd, win, rep, nl, bs


def _close(out, plain):
    err = (out.float() - plain.float()).abs().max().item()
    assert err <= ATTN_REL_TOL * plain.float().abs().max().item(), err


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("case", ATTN_CASES)
def test_paged_kvattn_matches_plain(dev, case, fmt):
    layer, _, q, posd, win, rep, nl, _ = _attn_inputs(case, fmt, dev)
    args = (q, layer.k, layer.k_scale, layer.v, layer.v_scale,
            layer.block_table, posd, win, rep, nl)
    out = paged_kvattn(*args, spec_of(fmt))
    plain = ref.paged_kvattn_ref(*args)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    _close(out, plain)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("case", ATTN_CASES)
def test_kvattn_matches_plain_and_paged(dev, case, fmt):
    """The slab kernel against its plain version, and bit for bit against
    the paged kernel over the same logical contents (block_s = block
    size, the whole table walked)."""
    layer, slab, q, posd, win, rep, _, bs = _attn_inputs(case, fmt, dev)
    spec = spec_of(fmt)
    args = (q, slab.k, slab.k_scale, slab.v, slab.v_scale, posd, win, rep)
    out = kvattn(*args, bs, spec)
    plain = ref.kvattn_ref(*args, bs)
    paged = paged_kvattn(q, layer.k, layer.k_scale, layer.v, layer.v_scale,
                         layer.block_table, posd, win, rep,
                         layer.blocks_per_slot, spec)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    _close(out, plain)
    assert torch.equal(out, paged)


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("case", [ATTN_CASES[1], ATTN_CASES[7]])
def test_attention_rows_independent_of_batch_and_n_live(dev, case, fmt):
    """A slot's rows are the same bits whatever its batch-mates (each slot
    alone against the whole batch) and whatever n_live bounds the paged
    walk (the live blocks against the whole table)."""
    layer, slab, q, posd, win, rep, _, bs = _attn_inputs(case, fmt, dev)
    spec = spec_of(fmt)
    B, bps = q.shape[0], layer.blocks_per_slot
    full = kvattn(q, slab.k, slab.k_scale, slab.v, slab.v_scale, posd, win,
                  rep, bs, spec)
    T = q.shape[2] // rep
    live = PKV.blocks_needed(int(posd.max()) + T, bs)
    for nl in (live, bps):
        paged = paged_kvattn(q, layer.k, layer.k_scale, layer.v,
                             layer.v_scale, layer.block_table, posd, win, rep,
                             nl, spec)
        assert torch.equal(paged, full), nl
    for b in range(B):
        one = kvattn(q[b:b + 1].contiguous(), slab.k[b:b + 1],
                     slab.k_scale[b:b + 1], slab.v[b:b + 1],
                     slab.v_scale[b:b + 1], posd[b:b + 1], win, rep, bs,
                     spec)
        assert torch.equal(one, full[b:b + 1]), b


@pytest.mark.parametrize("fmt", FORMATS)
def test_attention_rows_independent_of_chunking(dev, fmt):
    """A 32-token chunk's rows are the same bits as the same tokens fed
    one at a time (T 1 at pos + t against the same cache), on both
    backends: what chunked prefill ≡ decode needs on the card."""
    case = ATTN_CASES[1]
    layer, slab, q, posd, win, rep, nl, bs = _attn_inputs(case, fmt, dev)
    spec = spec_of(fmt)
    chunk = kvattn(q, slab.k, slab.k_scale, slab.v, slab.v_scale, posd, win,
                   rep, bs, spec)
    for t in (0, 1, 15, 16, 31):
        qt = q[:, :, t * rep:(t + 1) * rep].contiguous()
        pt = posd + t
        one = kvattn(qt, slab.k, slab.k_scale, slab.v, slab.v_scale, pt, win,
                     rep, bs, spec)
        paged = paged_kvattn(qt, layer.k, layer.k_scale, layer.v,
                             layer.v_scale, layer.block_table, pt, win, rep,
                             nl, spec)
        want = chunk[:, :, t * rep:(t + 1) * rep]
        assert torch.equal(one, want), t
        assert torch.equal(paged, want), t


@pytest.mark.parametrize("fmt", FORMATS)
def test_wide_head_rows_independent_of_chunking(dev, fmt):
    """At D 288 (two warps per row group, each half of D) a 32-token
    chunk straddling the window's lower edge gives the bits of the same
    tokens fed one at a time, on both backends."""
    layer, slab, q, posd, win, rep, nl, bs = _attn_inputs(WIDE_CHUNK_CASE,
                                                          fmt, dev)
    spec = spec_of(fmt)
    chunk = kvattn(q, slab.k, slab.k_scale, slab.v, slab.v_scale, posd, win,
                   rep, bs, spec)
    for t in (0, 13, 14, 31):      # slot 0: the window cuts from t 14
        qt = q[:, :, t * rep:(t + 1) * rep].contiguous()
        pt = posd + t
        one = kvattn(qt, slab.k, slab.k_scale, slab.v, slab.v_scale, pt, win,
                     rep, bs, spec)
        paged = paged_kvattn(qt, layer.k, layer.k_scale, layer.v,
                             layer.v_scale, layer.block_table, pt, win, rep,
                             nl, spec)
        want = chunk[:, :, t * rep:(t + 1) * rep]
        assert torch.equal(one, want), t
        assert torch.equal(paged, want), t


#: tiles whose staging needs more than the 227 KB of shared memory a block
#: may use, walked as sub-tiles (``flash::sub_rows``): (format, case) with
#: the case laid out as in ATTN_CASES
SUB_TILE_CASES = [
    ("kv8", (2, 2, 2, 128, 256, 2, [300, 17], 4, None, None)),   # 2 x 128
    ("kv8", (2, 2, 2, 128, 256, 3, [600, 200], 1, 100, None)),   # window
    #                               edge inside a sub-tile, decode rows
    ("kv8", (2, 5, 3, 64, 500, 1, [490, 255], 4, None, None)),   # the
    #                               max_seq 500 slab tile: 7 x 64 + 52
    ("kv8", (2, 5, 3, 64, 500, 2, [700, 490], 16, None, None)),  # a ragged
    #                               sub-tile followed by the next tile: its
    #                               padding rows' positions are live keys
    ("kv16", (2, 5, 3, 64, 512, 2, [700, 300], 4, None, None)),  # 2 x 256
    ("kv16", (2, 1, 4, 288, 64, 24, [1100, 700], 4, 1024, None)),  # D 288:
    #                               64-token blocks as 48 + 16, window
]


@pytest.mark.parametrize("fmt,case", SUB_TILE_CASES)
def test_sub_tiled_attention_matches_plain(dev, fmt, case):
    """A tile too large to stage whole (block_s 256 at D 128 kv8, the
    500-token slab tile at D 64 kv8, a 512-token pool block at D 64 kv16)
    is walked as sub-tiles: both kernels against their plain versions,
    dense ≡ paged bit for bit at block_s == block_size, and a chunk's rows
    the bits of the same tokens fed one at a time.  q and the keys carry
    opposite offsets that put every real score ~20 under the 0 an
    unmasked zero padding row of a ragged sub-tile would score."""
    D = case[3]
    layer, slab, q, posd, win, rep, nl, bs = _attn_inputs(
        case, fmt, dev, shift=(20 / D ** 0.5) ** 0.5)
    spec = spec_of(fmt)
    dargs = (q, slab.k, slab.k_scale, slab.v, slab.v_scale, posd, win, rep)
    pargs = (q, layer.k, layer.k_scale, layer.v, layer.v_scale,
             layer.block_table, posd, win, rep, nl)
    before = (kvattn.launches, paged_kvattn.launches)
    out = kvattn(*dargs, bs, spec)
    paged = paged_kvattn(*pargs, spec)
    torch.cuda.synchronize()
    assert (kvattn.launches, paged_kvattn.launches) == (before[0] + 1,
                                                         before[1] + 1)
    assert torch.isfinite(out.float()).all()
    _close(out, ref.kvattn_ref(*dargs, bs))
    _close(paged, ref.paged_kvattn_ref(*pargs))
    assert torch.equal(out, paged)
    T = q.shape[2] // rep
    for t in range(T):
        qt = q[:, :, t * rep:(t + 1) * rep].contiguous()
        one = kvattn(qt, *dargs[1:5], posd + t, win, rep, bs, spec)
        assert torch.equal(one, out[:, :, t * rep:(t + 1) * rep]), t


def test_kv_format_mismatch_raises(dev):
    slab = KV.init_cache(1, 16, 1, 64, spec_of("kv8"), device=dev).layer(0)
    q = torch.zeros((1, 1, 1, 64), dtype=torch.bfloat16, device=dev)
    pos = torch.zeros(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="kvfp8"):
        kvattn(q, slab.k, slab.k_scale, slab.v, slab.v_scale, pos,
               ref.NO_WINDOW, 1, 16, spec_of("kvfp8"))


GEMM_SHAPES = [  # K, N, bk, bn: every pick_blocks tile of smollm-360m
    (960, 960, 64, 96), (960, 320, 64, 64), (960, 2560, 64, 128),
    (2560, 960, 32, 96), (320, 320, 64, 64), (320, 640, 64, 128),
    (640, 320, 128, 64),
    # recurrentgemma-2b's packed GEMMs: wq/wo/wx/wy/wa/wi, wk/wv, w1/w3, w2
    (2560, 2560, 32, 128), (2560, 256, 32, 128), (2560, 7680, 32, 96),
    (7680, 2560, 32, 128),
    # whisper-tiny's: wq/wk/wv/wo (a K split of group-128 units), w1, w2
    (384, 384, 128, 128), (384, 1536, 128, 96), (1536, 384, 32, 128),
    # rwkv6-7b's decay LoRA: w_A one 64-wide column block; w_B a single
    # 64-deep K chunk at group 64 (fewer chunks than the cp.async ring's
    # stages, no K split)
    (4096, 64, 128, 64), (64, 4096, 64, 128),
    # K of 32 x an odd number at block_k = group = 32: the 32-deep tail
    # chunk alone (K 32), after one chunk (96), and at smollm-360m's
    # width (1056, a K split of 9 with the tail on the last rank)
    (32, 128, 32, 128), (96, 256, 32, 128), (1056, 960, 32, 96),
]
#: token counts: decode (1, 4), the kernels' token tiles of 8 / 16 / 32 /
#: 128 (int8: 64) and their edges (16, 17, 37, 64), a full prefill chunk
GEMM_MS = [1, 4, 16, 17, 37, 64, 128]


#: the packed GEMMs of gemma3-1b, chatglm3-6b and mistral-large-123b, as
#: ``models.common.pick_blocks`` tiles them: K, N, bk, bn
WIDE_GEMM_SHAPES = [
    (1152, 1152, 128, 128), (1152, 288, 128, 96), (1152, 6912, 128, 128),
    (6912, 1152, 128, 128),
    (4096, 4096, 128, 128), (4096, 256, 128, 128), (4096, 13696, 128, 128),
    (13696, 4096, 128, 128),
    (12288, 12288, 128, 128), (12288, 1024, 128, 64),
    (12288, 28672, 128, 128), (28672, 12288, 128, 128),
]


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("M", [4, 128])
@pytest.mark.parametrize("shape", WIDE_GEMM_SHAPES)
def test_gemms_match_plain_at_dense_config_widths(dev, shape, M, bits):
    """Both GEMM kernels against their plain versions at the three dense
    configs' widths (weights drawn on the card: the largest holds 352 M
    values)."""
    K, N, bk, bn = shape
    gen = torch.Generator(device=dev)
    gen.manual_seed(K + N + M + bits)
    w = torch.randn(K, N, generator=gen, device=dev) / K ** 0.5
    pw = pack_weight(w, bits=bits, group=bk, block_k=bk, block_n=bn)
    del w
    x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
    xq, xs = Q.quantize_act_per_token(x.float(), bits=8)
    for y, plain in ((mpgemm_a16(x, to_kernel_layout(pw, "a16")),
                      ref.mpgemm_ref(x, pw)),
                     (mpgemm_int8(xq, xs, to_kernel_layout(pw, "a8")),
                      ref.mpgemm_int8_ref(xq, xs, pw))):
        torch.cuda.synchronize()
        err = (y.float() - plain.float()).abs().max().item()
        assert err <= 2 ** -7 * plain.float().abs().max().item(), err


#: rwkv6-7b's wide packed GEMMs: the six 4096-square projections, ck and
#: cv (K, N, bk, bn)
RWKV_GEMM_SHAPES = [(4096, 4096, 128, 128), (4096, 14336, 128, 128),
                    (14336, 4096, 128, 128)]


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("M", [4, 128])
@pytest.mark.parametrize("shape", RWKV_GEMM_SHAPES)
def test_gemms_match_plain_at_rwkv6_widths(dev, shape, M, bits):
    test_gemms_match_plain_at_dense_config_widths(dev, shape, M, bits)


@pytest.mark.parametrize("label", ["gptq", "awq"])
def test_calibrated_weight_through_kernel(dev, label):
    """A weight calibrated on the card (GPTQ-lite, or AWQ with 1/s folded
    into x), packed by ``pack_prequantized`` and laid out for the A16
    kernel, against the plain version of the same packed weight."""
    from repro_torch.core import calibration as CAL
    from repro_torch.core.packing import pack_prequantized
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    K, N = 1024, 512
    w = torch.randn(K, N, generator=gen, device=dev) / K ** 0.5
    x = torch.randn(64, K, generator=gen, device=dev)
    if label == "gptq":
        q, sc = CAL.gptq_lite_quantize(w, x, bits=4, group=128)
        xs = torch.ones(K, device=dev)
    else:
        q, (sc, xs) = CAL.awq_quantize(w, x, bits=4, group=128)
    pw = pack_prequantized(q, sc, bits=4, group=128)
    xb = (x / xs).to(torch.bfloat16)
    y = mpgemm_a16(xb, to_kernel_layout(pw, "a16"))
    plain = ref.mpgemm_ref(xb, pw)
    torch.cuda.synchronize()
    err = (y.float() - plain.float()).abs().max().item()
    assert err <= 2 ** -7 * plain.float().abs().max().item(), err
    # and it computes x @ w up to the 4-bit quantization
    rel = (y.float() - x @ w).norm() / (x @ w).norm()
    assert rel.item() < 0.2


#: the packed GEMMs of llama4-scout-17b-a16e (attention, shared expert),
#: arctic-480b (attention, dense residual, the 128-wide router) and
#: internvl2-2b (attention, SwiGLU, img_proj at a 256-row image prefill),
#: as ``models.common.pick_blocks`` tiles them: K, N, bk, bn, token counts
MOE_VLM_GEMM_SHAPES = [
    (5120, 5120, 64, 64, (4, 128)), (5120, 1024, 64, 64, (4, 128)),
    (5120, 8192, 64, 128, (4, 128)), (8192, 5120, 128, 64, (4, 128)),
    (7168, 7168, 64, 64, (4, 128)), (7168, 1024, 64, 64, (4, 128)),
    (7168, 4864, 64, 128, (4, 128)), (4864, 7168, 128, 64, (4, 128)),
    (7168, 128, 64, 128, (4, 128)),
    (2048, 2048, 128, 128, (4, 319)), (2048, 1024, 128, 64, (4, 319)),
    (2048, 8192, 128, 128, (4, 319)), (8192, 2048, 128, 128, (4, 319)),
    (1024, 2048, 64, 128, (256,)),
]


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("shape", MOE_VLM_GEMM_SHAPES)
def test_gemms_match_plain_at_moe_and_vlm_widths(dev, shape, bits):
    """Both GEMM kernels against their plain versions at the moe and vlm
    configs' widths: a single 128-wide column block (arctic's router),
    M 256 and a ragged 319 (internvl2's image and one-shot prefills)."""
    K, N, bk, bn, Ms = shape
    gen = torch.Generator(device=dev)
    gen.manual_seed(K + N + bits)
    w = torch.randn(K, N, generator=gen, device=dev) / K ** 0.5
    pw = pack_weight(w, bits=bits, group=bk, block_k=bk, block_n=bn)
    for M in Ms:
        x = torch.randn(M, K, generator=gen, device=dev).to(torch.bfloat16)
        xq, xs = Q.quantize_act_per_token(x.float(), bits=8)
        for y, plain in ((mpgemm_a16(x, to_kernel_layout(pw, "a16")),
                          ref.mpgemm_ref(x, pw)),
                         (mpgemm_int8(xq, xs, to_kernel_layout(pw, "a8")),
                          ref.mpgemm_int8_ref(xq, xs, pw))):
            torch.cuda.synchronize()
            err = (y.float() - plain.float()).abs().max().item()
            assert err <= 2 ** -7 * plain.float().abs().max().item(), \
                (M, err)


#: decode attention at the moe and vlm configs' heads (D 128): llama4's 40
#: query heads on 8 KV heads (rep 5), arctic's 56 (rep 7), internvl2's 16
#: (rep 2) after its 256-row image prefill; T 1 and a 32-token chunk
#: (T x rep rows: 160 and 224 of the kernel's 16-row groups)
MOE_VLM_ATTN_CASES = [
    # B, Hkv, rep, D, bs, bps, pos, T, window, n_live
    (4, 8, 5, 128, 16, 16, [63, 36, 99, 0], 1, None, None),
    (4, 8, 5, 128, 16, 16, [32, 0, 64, 96], 32, None, None),
    (4, 8, 7, 128, 16, 16, [63, 36, 99, 0], 1, None, None),
    (4, 8, 7, 128, 16, 16, [32, 0, 64, 96], 32, None, None),
    (4, 8, 2, 128, 16, 24, [318, 70, 79, 63], 1, None, None),
]


@pytest.mark.parametrize("fmt", FORMATS)
@pytest.mark.parametrize("case", MOE_VLM_ATTN_CASES)
def test_attention_at_moe_and_vlm_heads(dev, case, fmt):
    """Both decode-attention kernels against their plain versions, dense
    ≡ paged bit for bit, and (chunks) a chunk's rows the bits of its
    tokens fed one at a time."""
    layer, slab, q, posd, win, rep, nl, bs = _attn_inputs(case, fmt, dev)
    spec = spec_of(fmt)
    args = (q, slab.k, slab.k_scale, slab.v, slab.v_scale, posd, win, rep)
    pargs = (q, layer.k, layer.k_scale, layer.v, layer.v_scale,
             layer.block_table, posd, win, rep, nl)
    out = kvattn(*args, bs, spec)
    paged = paged_kvattn(*pargs, spec)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    _close(out, ref.kvattn_ref(*args, bs))
    _close(paged, ref.paged_kvattn_ref(*pargs))
    assert torch.equal(out, paged)
    T = q.shape[2] // rep
    for t in {0, T // 2, T - 1}:
        one = kvattn(q[:, :, t * rep:(t + 1) * rep].contiguous(), *args[1:5],
                     posd + t, win, rep, bs, spec)
        assert torch.equal(one, out[:, :, t * rep:(t + 1) * rep]), t


def test_moe_ffn_on_the_card_matches_cpu(dev):
    """The moe layer (llama4-width router and experts, w4 packed stacks
    in the A16 GEMM's fragment order on the card, as the engine lays them
    out) against the same call on the CPU, both dispatches, ample
    capacity: the same routing, outputs within 2e-2 · max |y| (bf16
    matmuls summed in other orders)."""
    from repro_torch.configs import get_config
    from repro_torch.core.packing import pack_stack
    from repro_torch.models import moe as MOE
    cfg = dataclasses.replace(get_config("llama4-scout-17b-a16e"),
                              n_experts=4, d_ff=1024, capacity_factor=8.0)
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    gen = torch.Generator().manual_seed(7)
    lp = {"router": (torch.randn(d, E, generator=gen) * 0.02).bfloat16()}
    for name, shape in (("we1", (d, f)), ("we3", (d, f)), ("we2", (f, d))):
        w = torch.randn((E,) + shape, generator=gen) / shape[0] ** 0.5
        lp[name] = pack_stack(w, bits=4, group=64, block_k=64, block_n=128)
    x = torch.randn(4, 32, d, generator=gen).bfloat16()
    on_card = {k: v.to(dev) for k, v in lp.items()}
    on_card.update({k: to_kernel_layout(on_card[k], "a16")
                    for k in ("we1", "we3", "we2")})
    probs, _, idx = MOE.route(x, lp, cfg, None)
    idx_card = MOE.route(x.to(dev), on_card, cfg, None)[2].cpu()
    flip = (idx_card != idx).any(-1)                     # (B, S)
    # a flip only at a near-tie of the CPU's router probabilities
    gap = probs.gather(-1, idx) - probs.gather(-1, idx_card)
    assert gap.abs().max(-1).values[flip].le(4e-3).all()
    try:
        for impl in ("einsum", "sort"):
            MOE.set_dispatch_impl(impl)
            y_cpu = MOE.moe_ffn(x, lp, cfg).float()
            y = MOE.moe_ffn(x.to(dev), on_card, cfg).float().cpu()
            err = (y - y_cpu).abs()[~flip].max().item()
            assert err <= 2e-2 * y_cpu.abs().max().item(), impl
    finally:
        MOE.set_dispatch_impl("einsum")


def _gemm_inputs(shape, M, bits, dev):
    """A packed weight in the JAX package's tile-major layout (what the
    plain versions read here, so a wrong fragment permutation shows) and
    x."""
    K, N, bk, bn = shape
    rng = np.random.default_rng(K + N + M + bits)
    w = torch.from_numpy(rng.standard_normal((K, N), np.float32)) / K ** 0.5
    pw = pack_weight(w.to(dev), bits=bits, group=bk, block_k=bk, block_n=bn)
    x = torch.from_numpy(rng.standard_normal((M, K), np.float32)).to(
        dev, torch.bfloat16)
    return pw, x


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("M", GEMM_MS)
@pytest.mark.parametrize("shape", GEMM_SHAPES)
def test_mpgemm_matches_plain(dev, shape, M, bits):
    pw, x = _gemm_inputs(shape, M, bits, dev)
    y = mpgemm_a16(x, to_kernel_layout(pw, "a16"))
    plain = ref.mpgemm_ref(x, pw)
    torch.cuda.synchronize()
    err = (y.float() - plain.float()).abs().max().item()
    assert err <= 2 ** -7 * plain.float().abs().max().item(), err


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("M", GEMM_MS)
@pytest.mark.parametrize("shape", GEMM_SHAPES)
def test_mpgemm_int8_matches_plain(dev, shape, M, bits):
    pw, x = _gemm_inputs(shape, M, bits, dev)
    xq, xs = Q.quantize_act_per_token(x.float(), bits=8)
    y = mpgemm_int8(xq, xs, to_kernel_layout(pw, "a8"))
    plain = ref.mpgemm_int8_ref(xq, xs, pw)
    torch.cuda.synchronize()
    err = (y.float() - plain.float()).abs().max().item()
    assert err <= 2 ** -7 * plain.float().abs().max().item(), err


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("shape", GEMM_SHAPES)
def test_gemms_independent_of_batch(dev, shape, bits):
    """Row m of the output is the same bits whatever rows share the call
    (the K split and its combine order are fixed by the weight's shape,
    whatever token tile M picks): M 4, 37 and 128 against M 1 and M 4,
    for both kernels — what dense ≡ paged on the card needs of a mixed
    batch."""
    pw, x = _gemm_inputs(shape, 128, bits, dev)
    xq, xs = Q.quantize_act_per_token(x.float(), bits=8)
    p16, p8 = to_kernel_layout(pw, "a16"), to_kernel_layout(pw, "a8")
    runs = {"a16": lambda m: mpgemm_a16(x[:m], p16),
            "int8": lambda m: mpgemm_int8(xq[:m], xs[:m], p8)}
    for kern, run in runs.items():
        few = {m: run(m) for m in (1, 4)}
        for M in (4, 37, 128):
            y = run(M)
            for m, ym in few.items():
                assert torch.equal(y[:m], ym), (kern, M, m)


def test_tile_major_weight_rejected(dev):
    """Each kernel takes only its own fragment layout: a tile-major weight,
    or the other kernel's order, raises without launching (no silent
    repack per call)."""
    pw = pack_weight(torch.randn(64, 64, device=dev), bits=4, group=64,
                     block_k=64, block_n=64)
    x = torch.randn(4, 64, device=dev).to(torch.bfloat16)
    xq, xs = Q.quantize_act_per_token(x.float(), bits=8)
    before = (mpgemm_a16.launches, mpgemm_int8.launches)
    for w16, w8 in ((pw, pw), (to_kernel_layout(pw, "a8"),
                               to_kernel_layout(pw, "a16"))):
        with pytest.raises(ValueError, match="fragment layout"):
            mpgemm_a16(x, w16)
        with pytest.raises(ValueError, match="fragment layout"):
            mpgemm_int8(xq, xs, w8)
    assert (mpgemm_a16.launches, mpgemm_int8.launches) == before
    y = mpgemm_a16(x, to_kernel_layout(pw, "a16"))
    plain = ref.mpgemm_ref(x, pw)
    torch.cuda.synchronize()
    err = (y.float() - plain.float()).abs().max().item()
    assert err <= 2 ** -7 * plain.float().abs().max().item(), err


@pytest.mark.parametrize("policy", ["w4a16kv8", "w4a8kv4"])
def test_weight_without_fragment_layout_refused_at_load(dev, policy):
    """A packed weight whose K is 32 times an odd number has no fragment
    layout: the engine's load on the card names the weight and the K % 64
    rule instead of keeping a copy no kernel takes."""
    from repro_torch.core.precision import get_policy
    from repro_torch.serving.engine import quantize_params
    w = torch.randn(288, 256).to(torch.bfloat16)
    with pytest.raises(ValueError, match=r"weight layers/wq: .*K % 64 == 0"):
        quantize_params({"layers": {"wq": w}}, get_policy(policy),
                        device=dev)


def test_misaligned_input_rejected(dev):
    pw = to_kernel_layout(pack_weight(torch.randn(64, 64, device=dev),
                                      bits=4, group=64, block_k=64,
                                      block_n=64), "a16")
    buf = torch.zeros(4 * 64 + 1, device=dev, dtype=torch.bfloat16)
    x = buf[1:].view(4, 64)                   # 2-byte storage offset
    with pytest.raises(ValueError, match="misaligned"):
        mpgemm_a16(x, pw)


def test_wrappers_count_launches(dev):
    pw = pack_weight(torch.randn(64, 64, device=dev), bits=4, group=64,
                     block_k=64, block_n=64)
    p16, p8 = to_kernel_layout(pw, "a16"), to_kernel_layout(pw, "a8")
    x = torch.randn(4, 64, device=dev).to(torch.bfloat16)
    xq, xs = Q.quantize_act_per_token(x.float(), bits=8)
    before = (mpgemm_a16.launches, mpgemm_int8.launches)
    mpgemm_a16(x, p16)
    mpgemm_a16(x.cpu(), p16.to("cpu"))         # plain version: not counted
    mpgemm_int8(xq, xs, p8)
    mpgemm_int8(xq.cpu(), xs.cpu(), p8.to("cpu"))
    assert (mpgemm_a16.launches, mpgemm_int8.launches) == \
        (before[0] + 1, before[1] + 1)
    layer, slab, q, posd, win, rep, nl, bs = _attn_inputs(
        ATTN_CASES[2], "kv8", dev)
    kv8 = spec_of("kv8")
    before = (kvattn.launches, paged_kvattn.launches)
    kvattn(q, slab.k, slab.k_scale, slab.v, slab.v_scale, posd, win, rep, bs,
           kv8)
    paged_kvattn(q, layer.k, layer.k_scale, layer.v, layer.v_scale,
                 layer.block_table, posd, win, rep, nl, kv8)
    assert (kvattn.launches, paged_kvattn.launches) == \
        (before[0] + 1, before[1] + 1)


FLASH_CASES = [
    # B, H, Hkv, S, D, causal, window
    (1, 10, 1, 127, 256, True, 2048),   # recurrentgemma serve prompt
    (1, 10, 1, 700, 256, True, 256),    # the window binds, rep 10
    (1, 6, 6, 1500, 64, False, None),   # whisper encoder, ragged tiles
    (2, 6, 6, 15, 64, True, None),      # whisper decoder prompt, rep 1
    (2, 8, 2, 200, 128, True, None),    # D 128, rep 4
    (1, 8, 8, 96, 128, False, 40),      # non-causal window
    (1, 4, 4, 70, 32, True, None),      # whisper REDUCED head dim
    (1, 16, 8, 319, 128, True, None),   # internvl2: 256 image + 63 prompt
    (2, 4, 1, 300, 288, True, 128),     # gemma3 local: D 288, ragged S
    (1, 4, 1, 200, 288, True, None),    # gemma3 global
]


#: flash prefill's bar against its plain version: two bf16 ulps of the
#: largest output (both round p and the output to bf16 at the same points;
#: f32 sum order flips a rounding now and then)
FLASH_REL_TOL = 2 ** -6


def _flash_inputs(case, dev):
    """Scores of std 4, so one key or a mask edge moves the output by
    O(1); opposite constant offsets on q and k put every real score ~20
    under the 0 an unmasked all-zero padding key would score; v / 4 keeps
    outputs within ~1."""
    B, H, Hkv, S, D = case[:5]
    rng = np.random.default_rng(S + D)
    c = (20 / D ** 0.5) ** 0.5
    q, k, v = (rng.standard_normal((B, h, S, D), np.float32)
               for h in (H, Hkv, Hkv))
    return [torch.from_numpy(t).to(dev, torch.bfloat16)
            for t in (4 * q - c, k + c, v / 4)]


@pytest.mark.parametrize("case,tile", [
    (case, tile) for case in FLASH_CASES for tile in tiles(case[4])])
def test_flash_prefill_matches_plain(dev, case, tile):
    """Every tile the wrapper can choose, at every case."""
    q, k, v = _flash_inputs(case, dev)
    causal, window = case[5:]
    S = q.shape[2]
    for seq in (S, max(1, S - 9)):            # padded keys masked
        kw = dict(causal=causal, window=window, seq=seq, tile=tile)
        out = flash_prefill(q, k, v, **kw)
        plain = flash_prefill(q.cpu(), k.cpu(), v.cpu(), **kw)
        torch.cuda.synchronize()
        assert torch.isfinite(out.float()).all()
        err = (out.float().cpu() - plain.float()).abs().max().item()
        assert err <= FLASH_REL_TOL * plain.float().abs().max().item(), \
            (seq, err)


def test_flash_prefill_refuses(dev):
    """A negative offset is outside the kernel's contract (flash_attention
    raises); a tile past 227 KB of shared memory and an unbuilt head dim
    raise ValueError without launching."""
    from repro_torch.core.attention import flash_attention
    q, k, v = _flash_inputs(FLASH_CASES[0], dev)
    before = flash_prefill.launches
    with pytest.raises(ValueError, match="pos_offset"):
        flash_attention(q.transpose(1, 2), k[:, :, :64].transpose(1, 2),
                        v[:, :, :64].transpose(1, 2), pos_offset=-1)
    with pytest.raises(ValueError, match="shared memory"):
        flash_prefill(q, k, v, tile=(128, 256))   # D 256: 608 KB
    with pytest.raises(ValueError, match="head_dim"):
        flash_prefill(q[..., :48].contiguous(), k[..., :48].contiguous(),
                      v[..., :48].contiguous())
    assert flash_prefill.launches == before


def test_flash_prefill_counts_launches(dev):
    q, k, v = _flash_inputs(FLASH_CASES[3], dev)
    before = flash_prefill.launches
    flash_prefill(q, k, v)
    flash_prefill(q.cpu(), k.cpu(), v.cpu())           # plain: not counted
    assert flash_prefill.launches == before + 1


#: flash prefill's backward against its plain version (module docstring)
FLASH_BWD_REL_TOL = 2e-2
#: forward + backward cases: B, H, Hkv, Sq, Sk, D, causal, window — causal
#: rep 1 / 3 / 10, a window inside the sequence, non-causal (the encoder),
#: non-causal Sq != Sk (whisper's training cross attention), every head dim
FLASH_GRAD_CASES = [
    (2, 15, 5, 128, 128, 64, True, None),     # smollm-360m: rep 3
    (1, 10, 1, 300, 300, 256, True, 128),     # recurrentgemma: rep 10, window
    (2, 6, 6, 150, 150, 64, False, None),     # whisper encoder, ragged
    (2, 6, 6, 64, 150, 64, False, None),      # whisper cross attention
    (1, 16, 8, 319, 319, 128, True, None),    # internvl2: rep 2
    (2, 4, 4, 70, 70, 32, True, None),        # whisper REDUCED head dim
    (1, 8, 2, 96, 96, 128, False, 40),        # non-causal window
    (2, 4, 1, 300, 300, 288, True, 128),      # gemma3 local: D 288, ragged
    (1, 4, 1, 200, 200, 288, True, None),     # gemma3 global
    # the backward's plan splitting walks (bwd_plan): B 1 cross attention
    # at whisper's 1500 frames (6 dQ walks, each cut in splits) and a
    # gemma3 global layer at B 1 (both passes split, the triangle's long
    # walks most)
    (1, 6, 6, 64, 1500, 64, False, None),
    (1, 4, 1, 1024, 1024, 288, True, None),
]


def _grad_inputs(case, dev):
    B, H, Hkv, Sq, Sk, D = case[:6]
    rng = np.random.default_rng(Sq + Sk + D)
    c = (20 / D ** 0.5) ** 0.5
    q = rng.standard_normal((B, H, Sq, D), np.float32)
    k, v = (rng.standard_normal((B, Hkv, Sk, D), np.float32)
            for _ in range(2))
    do = rng.standard_normal((B, H, Sq, D), np.float32)
    return [torch.from_numpy(t).to(dev, torch.bfloat16)
            for t in (4 * q - c, k + c, v / 4, do)]


@pytest.mark.parametrize("case", FLASH_GRAD_CASES)
def test_flash_prefill_lse_and_cross_match_plain(dev, case):
    q, k, v, _ = _grad_inputs(case, dev)
    kw = dict(causal=case[6], window=case[7])
    out, lse = flash_prefill(q, k, v, return_lse=True, **kw)
    ref_out, ref_lse = flash_prefill(q.cpu(), k.cpu(), v.cpu(),
                                     return_lse=True, **kw)
    bare = flash_prefill(q, k, v, **kw)
    torch.cuda.synchronize()
    assert torch.equal(out, bare)
    err = (out.float().cpu() - ref_out.float()).abs().max().item()
    assert err <= FLASH_REL_TOL * ref_out.float().abs().max().item()
    torch.testing.assert_close(lse.cpu(), ref_lse, rtol=1e-5, atol=2e-4)


@pytest.mark.parametrize("case", FLASH_GRAD_CASES)
def test_flash_prefill_bwd_matches_plain(dev, case):
    q, k, v, do = _grad_inputs(case, dev)
    kw = dict(causal=case[6], window=case[7])
    out, lse = flash_prefill(q, k, v, return_lse=True, **kw)
    got = flash_prefill_bwd(q, k, v, out, lse, do, **kw)
    again = flash_prefill_bwd(q, k, v, out, lse, do, **kw)
    ref = flash_prefill_bwd(*(t.cpu() for t in (q, k, v, out, lse, do)),
                            **kw)
    torch.cuda.synchronize()
    for name, a, b, r in zip("qkv", got, again, ref):
        assert torch.equal(a, b), f"d{name} not repeatable"
        assert torch.isfinite(a.float()).all()
        err = (a.float().cpu() - r.float()).abs().max().item()
        assert err <= FLASH_BWD_REL_TOL * r.float().abs().max().item(), \
            (name, err)


def test_flash_attention_grad_runs_the_kernels(dev):
    """``core.attention.flash_attention`` under autograd on the card: one
    forward and one backward launch, gradients those of the backward
    kernel called directly; without grad the forward alone."""
    from repro_torch.core.attention import flash_attention
    q, k, v, do = _grad_inputs(FLASH_GRAD_CASES[0], dev)
    fwd, bwd = flash_prefill.launches, flash_prefill_bwd.launches
    leaves = [t.transpose(1, 2).clone().requires_grad_(True)
              for t in (q, k, v)]
    out = flash_attention(*leaves, causal=True)
    out.backward(do.transpose(1, 2))
    assert (flash_prefill.launches - fwd, flash_prefill_bwd.launches - bwd) \
        == (1, 1)
    o, lse = flash_prefill(q, k, v, return_lse=True)
    want = flash_prefill_bwd(q, k, v, o, lse, do)
    for leaf, w in zip(leaves, want):
        assert torch.equal(leaf.grad.transpose(1, 2), w)
    with torch.no_grad():
        flash_attention(*leaves, causal=True)
    assert flash_prefill_bwd.launches - bwd == 2


#: B, H, Hkv, Sq, Sk, D, causal, window, offset: sequence-parallel ranks'
#: rows (arctic's 56 / 8 heads cut to 2 ranks' depth, gemma3's D 288 with
#: its window crossing rank boundaries), o + Sq < Sk, Sq > Sk
FLASH_OFFSET_CASES = [
    (1, 56, 8, 256, 1024, 128, True, None, 768),
    (1, 56, 8, 256, 1024, 128, True, None, 256),
    (2, 4, 1, 512, 2048, 288, True, 1024, 1536),
    (2, 4, 1, 512, 2048, 288, True, 1024, 512),
    (1, 8, 2, 100, 700, 64, True, 130, 333),
    (2, 6, 6, 96, 64, 32, True, None, 0),
]


@pytest.mark.parametrize("case", FLASH_OFFSET_CASES)
def test_flash_kernels_at_offset_match_plain(dev, case):
    """Both kernels at a query position offset against their plain
    versions, at the bars of the offset-0 cases."""
    q, k, v, do = _grad_inputs(case, dev)
    kw = dict(causal=case[6], window=case[7], pos_offset=case[8])
    out, lse = flash_prefill(q, k, v, return_lse=True, **kw)
    got = flash_prefill_bwd(q, k, v, out, lse, do, **kw)
    ref_out, ref_lse = flash_prefill(q.cpu(), k.cpu(), v.cpu(),
                                     return_lse=True, **kw)
    ref = flash_prefill_bwd(*(t.cpu() for t in (q, k, v, out, lse, do)),
                            **kw)
    torch.cuda.synchronize()
    err = (out.float().cpu() - ref_out.float()).abs().max().item()
    assert err <= FLASH_REL_TOL * ref_out.float().abs().max().item()
    torch.testing.assert_close(lse.cpu(), ref_lse, rtol=1e-5, atol=2e-4)
    for name, a, r in zip("qkv", got, ref):
        err = (a.float().cpu() - r.float()).abs().max().item()
        assert err <= FLASH_BWD_REL_TOL * r.float().abs().max().item(), \
            (name, err)
