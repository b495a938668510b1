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
* Flash prefill — the kernel against its plain version (the same tile
  walk, ``ref.flash_prefill_walk``): the same rounding points, dot
  products summed in other orders (tensor-core fragments against
  PyTorch's matmul), so p may round to bf16 on the other side of a tie,
  plus one bf16 ulp of the output: |Δ| ≤ 2^-6 · max|plain| (two bf16
  ulps of the largest output), on inputs whose scores single out a few
  keys per row so a mask or window error moves the output by O(1).
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
from repro_torch.kernels.flashprefill import flash_prefill, tiles
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


def paged_case(seed, fmt, B, Hkv, D, bs, bps, lengths, device):
    """A per-layer pool holding ``lengths[b]`` random tokens for slot b
    through a shuffled block table (sentinel tail), every other pool cell
    filled with finite garbage; and the same tokens, written the same way,
    in a dense slab of ``bps * bs`` tokens per slot."""
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
        k, v = _tokens(rng, n, Hkv, D, device), _tokens(rng, n, Hkv, D, device)
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
]

#: decode attention's bar against its plain version: two bf16 ulps of the
#: largest output (see the module docstring)
ATTN_REL_TOL = 2 ** -6


def _attn_inputs(case, fmt, dev):
    """Peaked inputs: q ~ 4 N(0, 1) against keys of unit variance (scores
    of std 4), so a few keys carry each row."""
    B, Hkv, rep, D, bs, bps, pos, T, window, n_live = case
    layer, slab = paged_case(0, fmt, B, Hkv, D, bs, bps,
                             [p + T for p in pos], dev)
    rng = np.random.default_rng(1)
    q = torch.from_numpy(4 * rng.standard_normal(
        (B, Hkv, T * rep, D), np.float32)).to(dev, torch.bfloat16)
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


def test_kvattn_tile_too_large_raises(dev):
    """block_s = 256 at D = 128 needs more than 227 KB of shared memory:
    the wrapper raises instead of launching (no plain-version fallback)."""
    kv8 = spec_of("kv8")
    slab = KV.init_cache(1, 256, 1, 128, kv8, device=dev).layer(0)
    q = torch.zeros((1, 1, 2, 128), dtype=torch.bfloat16, device=dev)
    pos = torch.zeros(1, dtype=torch.int32, device=dev)
    before = kvattn.launches
    with pytest.raises(ValueError, match="shared memory"):
        kvattn(q, slab.k, slab.k_scale, slab.v, slab.v_scale, pos,
               ref.NO_WINDOW, 2, 256, kv8)
    assert kvattn.launches == before


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
]
#: token counts: decode (1, 4), the kernels' token tiles of 8 / 16 / 32 /
#: 128 (int8: 64) and their edges (16, 17, 37, 64), a full prefill chunk
GEMM_MS = [1, 4, 16, 17, 37, 64, 128]


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
    """Sq != Sk is outside the kernel's contract (flash_attention raises);
    a tile past 227 KB of shared memory and an unbuilt head dim raise
    ValueError without launching."""
    from repro_torch.core.attention import flash_attention
    q, k, v = _flash_inputs(FLASH_CASES[0], dev)
    before = flash_prefill.launches
    with pytest.raises(NotImplementedError, match="item 12"):
        flash_attention(q.transpose(1, 2), k[:, :, :64].transpose(1, 2),
                        v[:, :, :64].transpose(1, 2))
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
