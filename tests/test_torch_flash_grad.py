"""The gradient of the port's flash attention (CPU, plain versions)
against the JAX package, finite differences and exact attention.

* ``core.attention.flash_attention`` under autograd — the forward walk
  and ``ref.flash_prefill_bwd_ref`` behind the ``FlashPrefill`` autograd
  function — against ``jax.vjp`` of ``repro.core.attention.
  flash_attention`` (its XLA walk, which the reference differentiates):
  the same bf16 q, k, v and output gradient, causal, windowed, non-causal
  and non-causal Sq != Sk (whisper's training cross attention), rep 1 /
  3 / 4 / 10, head dims 32 / 64 / 256 / 288.  Outputs within 2e-2 · max
  |out| (one bf16 ulp and a p rounded on the other side of a tie), each
  gradient within 2e-2 · max |JAX gradient| (measured ≤ 7e-3: the two
  round P and dS to bf16 at other points — the port where its kernel
  does, JAX where its differentiated walk does).
* ``torch.autograd.gradcheck`` of the autograd function on f64 operands,
  where the plain versions round nothing: the backward math is the
  derivative of the forward.
* The lse the forward writes against ``logsumexp`` of the exact masked
  scores, and the backward's plain version against autograd through
  exact f32 attention (the bf16 roundings of P and dS within 2e-2).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import attention as JA
from repro_torch.convert import to_tensor
from repro_torch.core import attention as TA
from repro_torch.kernels.flashprefill import (FlashPrefill, flash_prefill,
                                              flash_prefill_bwd)
from repro_torch.kernels import ref as TREF
from repro_torch.kernels.ref import NEG_INF
from torch_defaults import package_defaults  # noqa: F401

# tiny tensors: one intra-op thread avoids the barrier waits that
# dominate when pytest-xdist workers share the cores
torch.set_num_threads(1)

TOL = 2e-2
CASES = [
    # B, Sq, Sk, H, Hkv, D, causal, window
    (1, 96, 96, 4, 4, 64, True, None),        # causal, rep 1
    (2, 70, 70, 6, 2, 32, True, 24),          # window, rep 3, ragged
    (1, 50, 50, 10, 1, 256, True, 16),        # recurrentgemma: rep 10, D 256
    (1, 60, 60, 4, 1, 64, False, None),       # encoder: non-causal, rep 4
    (2, 16, 40, 4, 4, 32, False, None),       # cross attention, Sq < Sk
    (1, 48, 20, 6, 2, 64, False, None),       # cross attention, Sq > Sk
    (1, 40, 40, 4, 1, 288, True, 16),         # gemma3: rep 4, D 288, window
]


def _inputs(case, seed=0):
    B, Sq, Sk, H, Hkv, D = case[:6]
    rng = np.random.default_rng(seed + Sq + D)
    shapes = ((B, Sq, H, D), (B, Sk, Hkv, D), (B, Sk, Hkv, D),
              (B, Sq, H, D))
    return [np.asarray(rng.standard_normal(s) * (0.5 if i < 3 else 1.0),
                       np.float32) for i, s in enumerate(shapes)]


def _f32(a):
    return a.float().numpy() if isinstance(a, torch.Tensor) else \
        np.asarray(a, np.float32)


@pytest.mark.parametrize("case", CASES)
def test_gradients_match_jax_vjp(case):
    causal, window = case[6:]
    q, k, v, do = (jnp.asarray(a, jnp.bfloat16) for a in _inputs(case))
    out_j, vjp = jax.vjp(lambda q, k, v: JA.flash_attention(
        q, k, v, causal=causal, window=window), q, k, v)
    grads_j = vjp(do)
    leaves = [to_tensor(np.asarray(a), "cpu").requires_grad_(True)
              for a in (q, k, v)]
    out_t = TA.flash_attention(*leaves, causal=causal, window=window)
    out_t.backward(to_tensor(np.asarray(do), "cpu"))
    assert np.abs(_f32(out_t.detach()) - _f32(out_j)).max() <= \
        TOL * np.abs(_f32(out_j)).max()
    for name, leaf, gj in zip("qkv", leaves, grads_j):
        assert leaf.grad.dtype == torch.bfloat16
        err = np.abs(_f32(leaf.grad) - _f32(gj)).max()
        assert err <= TOL * np.abs(_f32(gj)).max(), (name, err)


@pytest.mark.parametrize("causal,window,Sk", [
    (True, None, 6), (True, 3, 6), (False, None, 6), (False, None, 9)])
def test_gradcheck_in_f64(causal, window, Sk):
    g = torch.Generator().manual_seed(Sk)
    q = torch.randn(1, 4, 6, 8, dtype=torch.float64, generator=g)
    k, v = (torch.randn(1, 2, Sk, 8, dtype=torch.float64, generator=g)
            for _ in range(2))
    leaves = [t.requires_grad_(True) for t in (q, k, v)]
    assert torch.autograd.gradcheck(
        lambda q, k, v: FlashPrefill.apply(q, k, v, causal, window),
        leaves, eps=1e-6, atol=1e-8, rtol=1e-6)


def _exact(q, k, v, causal, window):
    """Exact attention in q's float dtype (head-major), its masked scores
    too."""
    D, Sq, Sk = q.shape[-1], q.shape[2], k.shape[2]
    rep = q.shape[1] // k.shape[1]
    kr, vr = (t.repeat_interleave(rep, dim=1) for t in (k, v))
    s = q @ kr.transpose(-1, -2) / D ** 0.5
    qpos, kpos = torch.arange(Sq)[:, None], torch.arange(Sk)[None]
    mask = torch.ones((Sq, Sk), dtype=torch.bool)
    if causal:
        mask &= kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    s = torch.where(mask, s, torch.full_like(s, NEG_INF))
    return torch.softmax(s, -1) @ vr, s


@pytest.mark.parametrize("case", CASES)
def test_lse_and_plain_backward_against_exact_attention(case):
    causal, window = case[6:]
    q, k, v, do = (torch.from_numpy(a).transpose(1, 2).contiguous()
                   .to(torch.bfloat16) for a in _inputs(case, seed=1))
    out, lse = flash_prefill(q, k, v, causal=causal, window=window,
                             return_lse=True)
    leaves = [t.float().requires_grad_(True) for t in (q, k, v)]
    ref, s = _exact(*leaves, causal, window)
    torch.testing.assert_close(lse, torch.logsumexp(s, -1).detach(),
                               rtol=1e-5, atol=1e-5)
    ref.backward(do.float())
    got = flash_prefill_bwd(q, k, v, out, lse, do, causal=causal,
                            window=window)
    for name, g, leaf in zip("qkv", got, leaves):
        assert g.dtype == torch.bfloat16 and g.shape == leaf.shape
        err = (g.float() - leaf.grad).abs().max().item()
        assert err <= TOL * leaf.grad.abs().max().item(), (name, err)


def test_no_grad_calls_save_nothing():
    """Serving calls (no grad wanted) take the bare forward: no graph, no
    lse; a grad call's output is the same bits."""
    q, k, v, _ = (torch.from_numpy(a).to(torch.bfloat16)
                  for a in _inputs(CASES[1]))
    with torch.no_grad():
        bare = TA.flash_attention(q, k, v, window=24)
    assert bare.grad_fn is None
    graded = TA.flash_attention(q.requires_grad_(True), k, v, window=24)
    assert graded.grad_fn is not None
    assert torch.equal(bare, graded.detach())


@pytest.mark.parametrize("kw", [dict(causal=True), dict(window=8,
                                                        causal=False)])
def test_masked_sq_ne_sk_still_refused(kw):
    """Sq != Sk with a causal mask or a window is refused only at a
    negative offset; at offset Sk - Sq its gradient is autograd's of the
    f32 oracle (bf16 operands: 2e-2 of the largest gradient)."""
    g = torch.Generator().manual_seed(12)
    q, k, v = (torch.randn(s, generator=g).bfloat16()
               for s in ((1, 8, 2, 32), (1, 12, 2, 32), (1, 12, 2, 32)))
    with pytest.raises(ValueError, match="pos_offset"):
        TA.flash_attention(q, k, v, pos_offset=-1, **kw)
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    out = TA.flash_attention(*leaves, pos_offset=4, **kw)
    ref = [t.float().clone().requires_grad_(True) for t in (q, k, v)]
    TREF.flash_prefill_ref(*ref, pos_offset=4, **kw).float().sum().backward()
    out.float().sum().backward()
    for a, r in zip(leaves, ref):
        err = (a.grad.float() - r.grad).abs().max().item()
        assert err <= 2e-2 * r.grad.abs().max().item() + 1e-3, err
