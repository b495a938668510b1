"""CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: every test takes the ``dev`` fixture, which skips when no
CUDA device is present (this file imports nothing of JAX, so it also runs
on a machine without it: ``python -m pytest --noconftest -q
tests/test_torch_cuda.py``).

Tolerances:

* GEMM — kernel and plain version multiply the same bf16 weights and
  accumulate in f32, in different orders; after the bf16 output rounding
  they may differ by one bf16 ulp: |Δ| ≤ 2^-7 · max|y|.
* Attention — same rounding points, but the kernel rounds the softmax
  weights to bf16 relative to its running max and the plain version
  relative to the global max (each ≤ 2^-9 relative), plus one bf16 ulp of
  the output: |Δ| ≤ 3e-2 on outputs of magnitude ≤ ~4.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch.core import paged_kvcache as PKV
from repro_torch.core.packing import pack_weight
from repro_torch.core.precision import get_policy
from repro_torch.kernels import ref
from repro_torch.kernels.mpgemm import mpgemm_w4a16
from repro_torch.kernels.paged_kvattn import paged_kvattn_kv8

pytestmark = pytest.mark.cuda

KV8 = get_policy("w4a16kv8").kv


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def paged_case(seed, B, Hkv, D, bs, bps, lengths, device):
    """A per-layer kv8 pool holding ``lengths[b]`` random tokens for slot
    b through a shuffled block table (sentinel tail), every other pool
    cell filled with finite garbage."""
    rng = np.random.default_rng(seed)
    nb = B * bps + 3
    cache = PKV.init_paged(B, nb, bs, Hkv, D, KV8, bps, device=device)
    layer = cache.layer(0)
    layer.k.copy_(torch.from_numpy(
        rng.integers(-127, 128, layer.k.shape, dtype=np.int8)))
    layer.v.copy_(torch.from_numpy(
        rng.integers(-127, 128, layer.v.shape, dtype=np.int8)))
    layer.k_scale.copy_(torch.from_numpy(
        rng.uniform(0.01, 0.05, layer.k_scale.shape).astype(np.float32)))
    layer.v_scale.copy_(torch.from_numpy(
        rng.uniform(0.01, 0.05, layer.v_scale.shape).astype(np.float32)))
    order = rng.permutation(nb)
    tbl = np.full((B, bps), nb, np.int32)
    nxt = 0
    for b, n in enumerate(lengths):
        need = PKV.blocks_needed(n, bs)
        tbl[b, :need] = order[nxt:nxt + need]
        nxt += need
    layer.block_table.copy_(torch.from_numpy(tbl))
    for b, n in enumerate(lengths):
        k = torch.from_numpy(rng.standard_normal((1, n, Hkv, D), np.float32))
        v = torch.from_numpy(rng.standard_normal((1, n, Hkv, D), np.float32))
        row = dataclasses.replace(layer, block_table=layer.block_table[b:b + 1])
        PKV.append_paged(row, k.to(device, torch.bfloat16),
                         v.to(device, torch.bfloat16),
                         torch.zeros(1, dtype=torch.int32, device=device), KV8)
    return layer


ATTN_CASES = [
    # B, Hkv, rep, D, bs, bps, pos, T, window, n_live
    (4, 5, 3, 64, 16, 16, [63, 36, 99, 0], 1, None, None),     # full decode
    (4, 5, 3, 64, 16, 16, [32, 0, 64, 96], 32, None, None),    # full chunk
    (2, 5, 1, 64, 8, 4, [4, 0], 4, None, 2),                  # reduced
    (2, 2, 2, 32, 4, 8, [9, 17], 4, 6, None),                  # window
    (2, 2, 2, 32, 8, 8, [36, 19], 4, None, 6),                 # live-bounded
    (3, 2, 4, 128, 64, 2, [70, 5, 127], 1, None, None),        # wide tiles
]


@pytest.mark.parametrize("case", ATTN_CASES)
def test_paged_kvattn_matches_plain(dev, case):
    B, Hkv, rep, D, bs, bps, pos, T, window, n_live = case
    lengths = [p + T for p in pos]
    layer = paged_case(0, B, Hkv, D, bs, bps, lengths, dev)
    rng = np.random.default_rng(1)
    q = torch.from_numpy(rng.standard_normal((B, Hkv, T * rep, D),
                                             np.float32)).to(dev, torch.bfloat16)
    posd = torch.tensor(pos, dtype=torch.int32, device=dev)
    win = ref.NO_WINDOW if window is None else window
    nl = bps if n_live is None else n_live
    out = paged_kvattn_kv8(q, layer.k, layer.k_scale, layer.v, layer.v_scale,
                           layer.block_table, posd, win, rep, nl)
    plain = ref.paged_kvattn_ref(q, layer.k, layer.k_scale, layer.v,
                                 layer.v_scale, layer.block_table, posd, win,
                                 rep, nl)
    torch.cuda.synchronize()
    assert torch.isfinite(out.float()).all()
    err = (out.float() - plain.float()).abs().max().item()
    assert err <= 3e-2, err


GEMM_SHAPES = [  # K, N, bk, bn: every pick_blocks tile of smollm-360m
    (960, 960, 64, 96), (960, 320, 64, 64), (960, 2560, 64, 128),
    (2560, 960, 32, 96), (320, 320, 64, 64), (320, 640, 64, 128),
    (640, 320, 128, 64),
]


@pytest.mark.parametrize("M", [1, 4, 37, 128])
@pytest.mark.parametrize("shape", GEMM_SHAPES)
def test_mpgemm_matches_plain(dev, shape, M):
    K, N, bk, bn = shape
    rng = np.random.default_rng(K + N + M)
    w = torch.from_numpy(rng.standard_normal((K, N), np.float32)) / K ** 0.5
    pw = pack_weight(w.to(dev), bits=4, group=bk, block_k=bk, block_n=bn)
    x = torch.from_numpy(rng.standard_normal((M, K), np.float32)).to(
        dev, torch.bfloat16)
    y = mpgemm_w4a16(x, pw)
    plain = ref.mpgemm_ref(x, pw)
    torch.cuda.synchronize()
    err = (y.float() - plain.float()).abs().max().item()
    assert err <= 2 ** -7 * plain.float().abs().max().item(), err


def test_misaligned_input_rejected(dev):
    pw = pack_weight(torch.randn(64, 64, device=dev), bits=4, group=64,
                     block_k=64, block_n=64)
    buf = torch.zeros(4 * 64 + 1, device=dev, dtype=torch.bfloat16)
    x = buf[1:].view(4, 64)                   # 2-byte storage offset
    with pytest.raises(ValueError, match="misaligned"):
        mpgemm_w4a16(x, pw)


def test_wrappers_count_launches(dev):
    pw = pack_weight(torch.randn(64, 64, device=dev), bits=4, group=64,
                     block_k=64, block_n=64)
    x = torch.randn(4, 64, device=dev).to(torch.bfloat16)
    before = mpgemm_w4a16.launches
    mpgemm_w4a16(x, pw)
    mpgemm_w4a16(x.cpu(), pw.to("cpu"))          # plain version: not counted
    assert mpgemm_w4a16.launches == before + 1
