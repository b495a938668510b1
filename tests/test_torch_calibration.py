"""The offline calibration and its packing helpers in the port against the
JAX package: ``core/calibration.py`` (AWQ grid search and quantizer,
GPTQ-lite with its per-column RTN fallback, SmoothQuant's factor),
``core/packing.py`` ``pack_prequantized`` / ``quantize_rowmajor`` /
``unpack_rowmajor`` and ``core/quantize.py`` ``quantize_fp8`` /
``dequantize_fp8``.

The same numpy inputs, drawn from a seed, go through jitted JAX and the
port on the CPU.  Integer and layout work is held bit for bit: packed
bytes, row-major nibbles, fp8 bytes and their per-tensor scale (the port
multiplies by ``f32(1 / 448)``, the form XLA compiles ``/ 448`` into).
The calibration's floating-point parts are held as they can be: AWQ picks
the same alpha; its per-channel scales ``amax ** alpha`` and the group
scales built on them, and GPTQ-lite's scales (its error feedback sums in
another order), sit within 4 f32 ulps of JAX's (``SCALE_RTOL``).  AWQ's
integers are equal except where the port's value before rounding sits
within ``TIE`` of a .5 tie (none on these draws); GPTQ-lite's, whose
fed-back values are internal, are held equal outright.  The beat-RTN
properties of
``tests/test_calibration.py`` hold for the port on the same problem.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import calibration as JCAL
from repro.core import packing as JPK
from repro.core import quantize as JQ
from repro_torch.convert import to_tensor
from repro_torch.core import calibration as TCAL
from repro_torch.core import packing as TPK
from repro_torch.core import quantize as TQ
from repro_torch.kernels.ref import mpgemm_ref
from torch_defaults import package_defaults  # noqa: F401

torch.set_num_threads(1)

#: f32 scales within 4 ulps of JAX's (relative)
SCALE_RTOL = 4 * 2.0 ** -23
#: a quantized value may differ from JAX's only this close to a .5 tie
TIE = 1e-4


@pytest.fixture(scope="module", params=[0, 1])
def salient(request):
    """Weights + calibration activations with a few salient channels (the
    JAX test's problem, drawn with numpy)."""
    rng = np.random.default_rng(request.param)
    K, N, T = 256, 64, 128
    w = (rng.standard_normal((K, N)) * 0.02).astype(np.float32)
    x = rng.standard_normal((T, K)).astype(np.float32)
    boost = np.ones(K, np.float32)
    boost[::37] += 30.0
    return w, x * boost[None]


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _scales_close(st, sj):
    sj = np.asarray(sj)
    np.testing.assert_allclose(st.numpy(), sj, rtol=SCALE_RTOL, atol=0)


def _q_equal_but_ties(qt, qj, pre):
    """Integers equal to JAX's except where ``pre`` (the port's value
    before rounding) lies within TIE of a .5 tie, and then by one."""
    qt, qj = qt.numpy().astype(np.int32), np.asarray(qj).astype(np.int32)
    bad = qt != qj
    if bad.any():
        frac = np.abs(np.abs(pre[bad]) - np.floor(np.abs(pre[bad])) - 0.5)
        assert (frac < TIE).all() and (np.abs(qt - qj)[bad] == 1).all()


def _recon_err(w, x, q, scales, group):
    deq = TQ.dequantize_weight_grouped(q, scales, group=group,
                                       dtype=torch.float32)
    err = x @ (deq - w)
    return float(torch.mean(err * err))


# ---------------------------------------------------------------------------
# AWQ
# ---------------------------------------------------------------------------


def test_awq_search_matches_jax(salient):
    w, x = salient
    search = jax.jit(JCAL.awq_search_scale,
                     static_argnames=("bits", "group", "n_grid"))
    sj, aj = search(jnp.asarray(w), jnp.asarray(x))
    st, at = TCAL.awq_search_scale(_t(w), _t(x))
    assert float(at) == float(aj)
    _scales_close(st, sj)
    alphas, _, _ = TCAL.awq_losses(_t(w), _t(x))
    np.testing.assert_array_equal(
        alphas.numpy().view(np.uint32),
        np.asarray(jnp.linspace(0.0, 1.0, 20)).view(np.uint32))


def test_awq_quantize_matches_jax(salient):
    w, x = salient
    quant = jax.jit(JCAL.awq_quantize, static_argnames=("bits", "group"))
    qj, (scj, sj) = quant(jnp.asarray(w), jnp.asarray(x))
    qt, (sct, st) = TCAL.awq_quantize(_t(w), _t(x))
    _scales_close(sct, scj)
    _scales_close(st, sj)
    G = w.shape[0] // 128
    pre = (_t(w).reshape(G, 128, -1) * st.reshape(G, 128, 1)
           / sct[:, None]).reshape(w.shape).numpy()
    _q_equal_but_ties(qt, qj, pre)


def test_awq_beats_rtn(salient):
    """The JAX test's property: the descaled AWQ weight reconstructs x @ w
    no worse than plain RTN, and the chosen alpha's loss is the grid's
    least, at most alpha 0's (RTN)."""
    w, x = _t(salient[0]), _t(salient[1])
    q0, s0 = TQ.quantize_weight_grouped(w, bits=4, group=128)
    err_rtn = _recon_err(w, x, q0, s0, 128)
    s, alpha = TCAL.awq_search_scale(w, x, bits=4, group=128)
    q1, s1 = TQ.quantize_weight_grouped(w * s[:, None], bits=4, group=128)
    deq = TQ.dequantize_weight_grouped(q1, s1, group=128,
                                       dtype=torch.float32) / s[:, None]
    err_awq = float(torch.mean(torch.square(x @ (deq - w))))
    assert err_awq <= err_rtn * 1.001, (err_awq, err_rtn)
    assert 0.0 <= float(alpha) <= 1.0
    alphas, losses, _ = TCAL.awq_losses(w, x)
    best = losses[alphas == alpha]
    assert float(best) == float(losses.min()) <= float(losses[0])


# ---------------------------------------------------------------------------
# GPTQ-lite
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits,group", [(4, 64), (4, 128), (8, 64)])
def test_gptq_lite_matches_jax(salient, bits, group):
    w, x = salient
    gptq = jax.jit(JCAL.gptq_lite_quantize, static_argnames=("bits", "group"))
    qj, sj = gptq(jnp.asarray(w), jnp.asarray(x), bits=bits, group=group)
    qt, st = TCAL.gptq_lite_quantize(_t(w), _t(x), bits=bits, group=group)
    _scales_close(st, sj)
    # the fed-back block values are internal: held equal outright (no
    # tie within a few ulps on these draws)
    np.testing.assert_array_equal(qt.numpy(), np.asarray(qj))


def test_gptq_lite_beats_rtn(salient):
    w, x = _t(salient[0]), _t(salient[1])
    q0, s0 = TQ.quantize_weight_grouped(w, bits=4, group=64)
    err_rtn = _recon_err(w, x, q0, s0, 64)
    q1, s1 = TCAL.gptq_lite_quantize(w, x, bits=4, group=64)
    assert _recon_err(w, x, q1, s1, 64) <= err_rtn * 1.05
    # per column, never worse than RTN (the fallback's guarantee)
    ct = TCAL._col_err(q1, s1, x, w, 64)
    cr = TCAL._col_err(q0, s0, x, w, 64)
    assert bool((ct <= cr).all())


def test_smoothquant_factor_matches_jax():
    rng = np.random.default_rng(2)
    x = (rng.standard_normal((64, 128)) * 10).astype(np.float32)
    w = rng.standard_normal((128, 32)).astype(np.float32)
    for alpha in (0.5, 0.8):
        fj = jax.jit(JCAL.smoothquant_factor, static_argnames=("alpha",))(
            jnp.asarray(x), jnp.asarray(w), alpha=alpha)
        ft = TCAL.smoothquant_factor(_t(x), _t(w), alpha=alpha)
        assert ft.shape == (128,) and bool((ft > 0).all())
        np.testing.assert_allclose(ft.numpy(), np.asarray(fj), rtol=1e-6)


# ---------------------------------------------------------------------------
# Packing helpers and fp8
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bits,group,bk,bn", [(4, 128, 128, 128),
                                              (4, 64, 64, 128),
                                              (8, 128, 128, 64)])
def test_pack_prequantized_bit_for_bit(bits, group, bk, bn):
    """GPTQ-lite's integers packed by both packages: the same tile bytes;
    the port's packed weight unpacks to them in the tile layout and in
    both kernels' fragment orders, and its plain GEMM is the dequantized
    weight's product."""
    rng = np.random.default_rng(3)
    K, N = 256, 128
    w = (rng.standard_normal((K, N)) * 0.02).astype(np.float32)
    x = rng.standard_normal((64, K)).astype(np.float32)
    q, s = TCAL.gptq_lite_quantize(_t(w), _t(x), bits=bits, group=group)
    pj = JPK.pack_prequantized(jnp.asarray(q.numpy()), jnp.asarray(s.numpy()),
                               bits=bits, group=group, block_k=bk,
                               block_n=bn)
    pt = TPK.pack_prequantized(q, s, bits=bits, group=group, block_k=bk,
                               block_n=bn)
    np.testing.assert_array_equal(pt.data.numpy(), np.asarray(pj.data))
    np.testing.assert_array_equal(pt.scales.numpy(), np.asarray(pj.scales))
    assert (pt.bits, pt.group, pt.block_k, pt.block_n, pt.shape) == \
        (pj.bits, pj.group, pj.block_k, pj.block_n, pj.shape)
    for layout in ("a16", "a8"):
        np.testing.assert_array_equal(
            TPK.unpack_weight(TPK.to_kernel_layout(pt, layout)).numpy(),
            q.numpy())
    xb = _t(x[:4]).to(torch.bfloat16)
    wd = TQ.dequantize_weight_grouped(q, s, group=group)
    np.testing.assert_array_equal(mpgemm_ref(xb, pt).float().numpy(),
                                  torch.matmul(xb.float(), wd.float()).to(
                                      torch.bfloat16).float().numpy())


@pytest.mark.parametrize("bits", [4, 8])
def test_rowmajor_bit_for_bit(bits):
    rng = np.random.default_rng(4)
    w = rng.standard_normal((256, 96)).astype(np.float32)
    uj = jax.jit(JPK.quantize_rowmajor, static_argnames=("bits", "group"))(
        jnp.asarray(w), bits=bits, group=128)
    ut = TPK.quantize_rowmajor(_t(w), bits=bits, group=128)
    assert ut.shape == tuple(uj.shape) and ut.data.shape == uj.data.shape
    np.testing.assert_array_equal(ut.data.numpy(), np.asarray(uj.data))
    np.testing.assert_array_equal(ut.scales.numpy().view(np.uint32),
                                  np.asarray(uj.scales).view(np.uint32))
    np.testing.assert_array_equal(TPK.unpack_rowmajor(ut).numpy(),
                                  np.asarray(JPK.unpack_rowmajor(uj)))
    q, _ = TQ.quantize_weight_grouped(_t(w), bits=bits, group=128)
    np.testing.assert_array_equal(TPK.unpack_rowmajor(ut).numpy(),
                                  q.numpy())


@pytest.mark.parametrize("scale", [1.0, 1e-3, 300.0, 0.0])
@pytest.mark.parametrize("dtype", ["float8_e4m3fn", "float8_e5m2"])
def test_fp8_bit_for_bit(scale, dtype):
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((64, 96)) * scale).astype(np.float32)
    x[0, :3] = [0.0, -0.0, scale]
    quant = jax.jit(JQ.quantize_fp8, static_argnames=("dtype",))
    qj, sj = quant(jnp.asarray(x), dtype=getattr(jnp, dtype))
    qt, st = TQ.quantize_fp8(_t(x), dtype=getattr(torch, dtype))
    assert qt.dtype == getattr(torch, dtype) and st.shape == ()
    np.testing.assert_array_equal(qt.view(torch.uint8).numpy(),
                                  to_tensor(np.asarray(qj), "cpu")
                                  .view(torch.uint8).numpy())
    assert np.float32(st).view(np.uint32) == \
        np.asarray(sj, np.float32).view(np.uint32)
    dj = jax.jit(JQ.dequantize_fp8)(qj, sj)
    dt = TQ.dequantize_fp8(qt, st)
    np.testing.assert_array_equal(dt.float().numpy(),
                                  to_tensor(np.asarray(dj), "cpu")
                                  .float().numpy())
