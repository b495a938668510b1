"""A K of 32 times an odd number through the port's GEMM path, against the
JAX package (CPU, plain versions).

The Pallas GEMMs (``repro.kernels.mpgemm.mpgemm_2d`` / ``mpgemm_int8_2d``)
take any K that is ``Kt · block_k`` with ``group == block_k``, and
``pick_blocks`` keeps block_k ≥ 32, so K = 32 × odd packs at block_k =
group = 32.  The CUDA GEMMs read K in 64-deep chunks; their fragment
layouts (``core.packing.to_kernel_layout``) give such a K a last chunk of
32 real rows and 32 rows of zero codes, whose other x columns and scale
row the kernels zero-fill (``csrc/gemm_tile.cuh``).

* The fragment layouts round-trip bit for bit at K 96 / 160 / 1056 (the
  JAX package's unpacked values, no padded row), the padded codes zero.
* The Pallas kernels in interpret mode at K 96 and 160 against the
  port's plain versions on the port's packing (tile and both fragment
  layouts): codes and scales bit for bit, outputs within
  ``test_torch_kernels``' bar, |Δ| ≤ 2^-7 · max|y| (one bf16 ulp).
* smollm-360m REDUCED with d_ff 480 (15 × 32: w2 packs at block_k 32)
  teacher-forced through the port's ``decode_step`` against the JAX
  engine's, each package packing its weights by its engine's loader, at
  ``test_torch_model``'s bars (A16 2e-2, A8 1e-1); the fragment layouts
  give the tile layout's logits bit for bit.
* Refusals, the wrapper's operand check, the declared cost and the
  sharding rule at the tail.
"""
import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import get_reduced as j_reduced
from repro.core import packing as JP
from repro.core import quantize as JQ
from repro.core.precision import get_policy as j_policy
from repro.kernels import mpgemm as JMG
from repro.models import transformer as JT
from repro.serving.engine import quantize_params as j_quantize
from repro_torch.configs import get_reduced as t_reduced
from repro_torch.convert import params_from_jax, to_tensor
from repro_torch.core import packing as TP
from repro_torch.core import quantize as TQ
from repro_torch.core.precision import get_policy as t_policy
from repro_torch.kernels import cost as KC
from repro_torch.kernels import ref as TREF
from repro_torch.kernels.mpgemm import _check_weight
from repro_torch.launch.sharding import ShardingRules
from repro_torch.models import transformer as TT
from repro_torch.serving.engine import quantize_params as t_quantize
from test_torch_model import _teacher_forced
from torch_defaults import package_defaults  # noqa: F401

# tiny tensors: one intra-op thread avoids the barrier waits that
# dominate when pytest-xdist workers share the cores
torch.set_num_threads(1)

KERNELS = ("a16", "a8")
D_FF = 480                  # 15 x 32


def _w(K, N, seed):
    w = np.random.default_rng(seed).standard_normal((K, N)) / np.sqrt(K)
    return w.astype(np.float32)


def _np(t):
    """torch or JAX array → numpy, f32 as uint32 bits (bitwise compare)."""
    a = t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)
    return a.view(np.uint32) if a.dtype == np.float32 else a


def _padded(pf):
    """All ceil(K/64)·64 rows a fragment layout holds, padding included."""
    Kp = TP.frag_chunks(pf.shape[0]) * TP.FRAG_K
    return TP.unpack_weight(dataclasses.replace(pf, shape=(Kp, pf.shape[1])))


@pytest.mark.parametrize("kernel", KERNELS)
@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("N", [16, 256])
@pytest.mark.parametrize("K", [96, 160, 1056])
def test_kernel_layout_round_trips_at_the_tail(K, N, bits, kernel):
    w = _w(K, N, K + N + bits)
    bn = min(N, 128)
    pj = JP.pack_weight(jnp.asarray(w), bits=bits, group=32, block_k=32,
                        block_n=bn)
    pt = TP.pack_weight(torch.from_numpy(w), bits=bits, group=32,
                        block_k=32, block_n=bn)
    pf = TP.to_kernel_layout(pt, kernel)
    C = -(-K // 64)
    assert pf.layout == f"frag_{kernel}" and pf.shape == (K, N)
    assert tuple(pf.data.shape) == (N // 16, C, 32, 4 * bits)
    assert tuple(pf.scales.shape) == (K // 32, N)
    np.testing.assert_array_equal(_np(TP.unpack_weight(pf)),
                                  _np(JP.unpack_weight(pj)))
    np.testing.assert_array_equal(
        _np(TP.dequantize_packed(pf, torch.float32)),
        _np(JP.dequantize_packed(pj, jnp.float32)))
    full = _padded(pf)
    assert torch.equal(full[:K], TP.unpack_weight(pt))
    assert not full[K:].any()                      # the tail's zero codes
    assert pf.storage_bytes == pt.storage_bytes + 32 * N * bits // 8


def _pallas_pair(K, bits, seed, M=3, N=256, bn=128):
    """A weight packed by JAX and by the port (group = block_k = 32), x,
    and the JAX kernel's inputs carried across."""
    w = _w(K, N, seed)
    pj = JP.pack_weight(jnp.asarray(w), bits=bits, group=32, block_k=32,
                        block_n=bn)
    pt = TP.pack_weight(torch.from_numpy(w), bits=bits, group=32,
                        block_k=32, block_n=bn)
    carried = dataclasses.replace(pt, data=to_tensor(np.asarray(pj.data),
                                                     "cpu"),
                                  scales=to_tensor(np.asarray(pj.scales),
                                                   "cpu"))
    np.testing.assert_array_equal(_np(pt.data), _np(carried.data))
    np.testing.assert_array_equal(_np(pt.scales), _np(carried.scales))
    rng = np.random.default_rng(seed + 1)
    x = jnp.asarray(rng.standard_normal((M, K)), jnp.bfloat16)
    return pj, pt, x


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("K", [96, 160])
def test_plain_a16_matches_pallas_at_the_tail(K, bits):
    pj, pt, x = _pallas_pair(K, bits, 10 * K + bits)
    y_pl = np.asarray(JMG.mpgemm_2d(x, pj.data, pj.scales, bits=bits,
                                    group=32, block_m=x.shape[0],
                                    interpret=True), np.float32)
    xt = to_tensor(np.asarray(x), "cpu")
    tol = 2 ** -7 * np.abs(y_pl).max()
    ys = [TREF.mpgemm_ref(xt, p) for p in
          [pt] + [TP.to_kernel_layout(pt, k) for k in KERNELS]]
    for y in ys:
        assert torch.equal(y, ys[0])              # every layout, same bits
    assert np.abs(ys[0].float().numpy() - y_pl).max() <= tol


@pytest.mark.parametrize("bits", [4, 8])
@pytest.mark.parametrize("K", [96, 160])
def test_plain_int8_matches_pallas_at_the_tail(K, bits):
    pj, pt, x = _pallas_pair(K, bits, 20 * K + bits)
    xq, xs = JQ.quantize_act_per_token(x.astype(jnp.float32), bits=8)
    y_pl = np.asarray(JMG.mpgemm_int8_2d(xq, xs, pj.data, pj.scales,
                                         bits=bits, group=32,
                                         block_m=x.shape[0], interpret=True),
                      np.float32)
    xqt, xst = TQ.quantize_act_per_token(
        to_tensor(np.asarray(x), "cpu").float(), bits=8)
    np.testing.assert_array_equal(xqt.numpy(), np.asarray(xq))
    tol = 2 ** -7 * np.abs(y_pl).max()
    ys = [TREF.mpgemm_int8_ref(xqt, xst, p) for p in
          [pt] + [TP.to_kernel_layout(pt, k) for k in KERNELS]]
    for y in ys:
        assert torch.equal(y, ys[0])
    assert np.abs(ys[0].float().numpy() - y_pl).max() <= tol


@pytest.fixture(scope="module")
def tail_raw():
    cfg_j = dataclasses.replace(j_reduced("smollm-360m"), d_ff=D_FF)
    cfg_t = dataclasses.replace(t_reduced("smollm-360m"), d_ff=D_FF)
    raw_j = JT.init_params(cfg_j, jax.random.PRNGKey(0))
    return cfg_j, cfg_t, raw_j, jax.device_get(raw_j)


def _tail_models(tail_raw, policy):
    cfg_j, cfg_t, raw_j, raw_np = tail_raw
    pol_j, pol_t = j_policy(policy), t_policy(policy)
    params_j = j_quantize(raw_j, pol_j)
    params_t = t_quantize(params_from_jax(raw_np, cfg_t, device="cpu"),
                          pol_t)
    return cfg_j, cfg_t, pol_j, pol_t, params_j, params_t


@pytest.mark.parametrize("kind", ["dense", "paged"])
@pytest.mark.parametrize("policy", ["w4a16kv8", "w8a16kv16", "w4a8kv4"])
def test_d_ff_480_logits_match_jax_engine(tail_raw, policy, kind):
    models = _tail_models(tail_raw, policy)
    cfg_t, params_j, params_t = models[1], models[4], models[5]
    for i in range(cfg_t.n_layers):
        pt, pj = params_t["layers"][i]["w2"], params_j["layers"]["w2"]
        assert pt.shape == (D_FF, cfg_t.d_model)
        assert (pt.block_k, pt.group, pj.block_k, pj.group) == (32,) * 4
        np.testing.assert_array_equal(_np(pt.data), np.asarray(pj.data[i]))
        np.testing.assert_array_equal(_np(pt.scales),
                                      _np(np.asarray(pj.scales[i])))
    _teacher_forced(*models, kind)


def _frag_params(params, kernel):
    """A parameter tree with every packed 2-D weight in ``kernel``'s
    fragment layout (the engine's layout on the card)."""
    if isinstance(params, dict):
        return {k: _frag_params(v, kernel) for k, v in params.items()}
    if isinstance(params, list):
        return [_frag_params(v, kernel) for v in params]
    if isinstance(params, TP.PackedWeight):
        return TP.to_kernel_layout(params, kernel)
    return params


@pytest.mark.parametrize("policy", ["w4a16kv8", "w4a8kv4"])
def test_d_ff_480_fragment_layout_gives_the_same_logits(tail_raw, policy):
    """The plain versions on the fragment layouts (the tail's padding
    dropped on unpacking) give the tile layout's logits bit for bit."""
    _, cfg_t, _, pol_t, _, params_t = _tail_models(tail_raw, policy)
    frag = _frag_params(params_t, "a8" if pol_t.int8_matmul else "a16")
    assert frag["layers"][0]["w2"].data.shape[1] == -(-D_FF // 64)
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        1, cfg_t.vocab, (2, 5)).astype(np.int64))
    out = []
    for p in (params_t, frag):
        cache = TT.init_cache(cfg_t, pol_t, 2, 16, device="cpu")
        out.append(TT.decode_step(p, cfg_t, pol_t, toks, cache,
                                  torch.zeros(2, dtype=torch.int32))[0])
    assert torch.isfinite(out[0].float()).all()
    assert torch.equal(out[0], out[1])


@pytest.mark.parametrize("K,N,group", [(48, 256, 16), (256, 24, 64)])
def test_kernel_layout_still_refuses(K, N, group):
    """K = 48 (not a multiple of 64, and not a 32-deep tail at group 32)
    and N = 24 (not 16-wide blocks) have no fragment layout."""
    pt = TP.pack_weight(torch.from_numpy(_w(K, N, 3)), bits=4, group=group,
                        block_k=group, block_n=N if N % 128 else 128)
    for kernel in KERNELS:
        with pytest.raises(ValueError, match="fragment layout needs"):
            TP.to_kernel_layout(pt, kernel)


@pytest.mark.parametrize("kernel", KERNELS)
def test_wrapper_takes_the_tail_operand(kernel):
    """The wrappers' check takes (N/16, ceil(K/64), 32, 4·bits) data at
    K = 32 × odd, and refuses the K/64 chunks a tail-less layout would
    have."""
    pf = TP.to_kernel_layout(TP.pack_weight(
        torch.from_numpy(_w(160, 128, 5)), bits=4, group=32, block_k=32),
        kernel)
    x = torch.zeros((3, 160), dtype=torch.bfloat16 if kernel == "a16"
                    else torch.int8)
    _check_weight(x, pf, kernel)
    short = dataclasses.replace(pf, data=pf.data[:, :2].contiguous())
    with pytest.raises(ValueError, match=r"W.data.*\(8, 3, 32, 16\)"):
        _check_weight(x, short, kernel)


def test_cost_counts_the_real_k_and_the_bytes_the_function_needs():
    """The real K's operations and weight bytes, whatever layout the call
    holds: the fragment layout's 32 padded zero rows are not counted."""
    K, N, M = 160, 128, 4
    pt = TP.pack_weight(torch.from_numpy(_w(K, N, 6)), bits=4, group=32,
                        block_k=32)
    pf = TP.to_kernel_layout(pt, "a16")
    x = torch.zeros((M, K), dtype=torch.bfloat16)
    need = K * N // 2 + (K // 32) * N * 4
    assert KC.weight_bytes(pt) == KC.weight_bytes(pf) == need == \
        pt.storage_bytes == pf.storage_bytes - 32 * N // 2
    want = (2 * M * N * K, M * K * 2 + need + M * N * 2)
    for p in (pt, pf):
        assert KC.of_mpgemm_a16(x, p) == want
    xs = torch.ones((M, 1))
    assert KC.of_mpgemm_int8(x.to(torch.int8), xs, pt) == \
        (want[0], M * K + M * 4 + need + M * N * 2)


def test_fragment_spec_keeps_a_tail_weight_whole_on_k():
    """A row-parallel weight shards K on "model" in 64-deep fragments;
    with a 32-deep tail no shard holds its K whole, so K stays
    unsharded."""
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": 1, "model": 4})
    rules = ShardingRules(mesh, t_reduced("smollm-360m"), fsdp=False)
    specs = {}
    for K in (512, 480):
        p = TP.to_kernel_layout(TP.pack_weight(
            torch.from_numpy(_w(K, 256, 7)), bits=4, group=32, block_k=32),
            "a16")
        specs[K] = rules.frag_spec("w2", p)
    assert specs[512][1] == "model"
    assert specs[480][1] is None
