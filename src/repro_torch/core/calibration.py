"""Quantization calibration: AWQ-style activation-aware scaling and a
GPTQ-lite column-wise error-compensating quantizer.

Port of ``repro.core.calibration``, the offline half of the paper's GEMM
pipeline (it serves AWQ and GPTQ checkpoints, §5.1): the integers and
scales these functions return go to :func:`core.packing.pack_prequantized`
and from there, like any packed weight, to the GEMM kernels.  Everything
is plain PyTorch on the inputs' device; the reference's ``lax.map`` over
the alpha grid and ``lax.scan`` over the groups are Python loops.

* AWQ (Lin et al., 2024): per-input-channel scales ``s = amax^α`` from the
  normalized activation magnitudes, α on a 20-point grid in [0, 1] chosen
  to minimize the output MSE on the calibration activations (α = 0 is
  plain round-to-nearest, so the chosen α never does worse on them).
* GPTQ-lite: group-by-group quantization along K with the diagonal-Hessian
  error feedback ``H ≈ diag(E[x²])`` into the rows not yet quantized, and a
  per-output-column fallback to round-to-nearest wherever that
  reconstructs the column better on the calibration set — never worse
  than RTN by construction.
"""
from __future__ import annotations

from typing import Tuple

import torch

from . import quantize as Q


def awq_losses(w: torch.Tensor, x_calib: torch.Tensor, bits: int = 4,
               group: int = 128, n_grid: int = 20
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The AWQ grid search's pieces: (alphas (n_grid,), the output MSE of
    each on the calibration set (n_grid,), the normalized per-channel
    activation magnitudes (K,)).  w: (K, N); x_calib: (T, K)."""
    amax = torch.clamp_min(x_calib.abs().mean(0), 1e-8)
    amax = amax / torch.exp(torch.log(amax).mean())
    alphas = torch.arange(n_grid, dtype=torch.float32,
                          device=w.device) / (n_grid - 1)
    losses = []
    for alpha in alphas:
        s = amax ** alpha
        q, sc = Q.quantize_weight_grouped(w * s[:, None], bits=bits,
                                          group=group)
        wq = Q.dequantize_weight_grouped(q, sc, group=group,
                                         dtype=torch.float32) / s[:, None]
        err = x_calib @ (wq - w).float()
        losses.append(torch.mean(err * err))
    return alphas, torch.stack(losses), amax


def awq_search_scale(w: torch.Tensor, x_calib: torch.Tensor, bits: int = 4,
                     group: int = 128, n_grid: int = 20
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(best per-channel scale s (K,), best alpha ()) of the grid search;
    the first alpha of the least loss wins a tie, as ``jnp.argmin``."""
    alphas, losses, amax = awq_losses(w, x_calib, bits, group, n_grid)
    best = alphas[torch.argmin(losses)]
    return amax ** best, best


def awq_quantize(w: torch.Tensor, x_calib: torch.Tensor, bits: int = 4,
                 group: int = 128
                 ) -> Tuple[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """AWQ: scale, then quantize.  Returns (q (K, N) int8-held values,
    (group scales (K/group, N), per-row s (K,))): ``q * scale / s ≈ w``, so
    the caller folds 1/s into the producer of x (``x / s`` against the
    packed ``(q, scales)``)."""
    s, _ = awq_search_scale(w, x_calib, bits=bits, group=group)
    K, N = w.shape
    G = K // group
    sc = Q.absmax_scale((w * s[:, None]).reshape(G, group, N), dim=1,
                        qmax=2 ** (bits - 1) - 1)              # (G, 1, N)
    q = Q.quantize_int(w.reshape(G, group, N) * s.reshape(G, group, 1),
                       sc, bits).reshape(K, N)
    return q, (sc[:, 0, :], s)


def _col_err(q, s, xf, wf, group):
    """Per-output-column MSE of the dequantized weight on x: (N,)."""
    deq = Q.dequantize_weight_grouped(q, s, group=group, dtype=torch.float32)
    return torch.mean((xf @ (deq - wf)) ** 2, dim=0)


def gptq_lite_quantize(w: torch.Tensor, x_calib: torch.Tensor,
                       bits: int = 4, group: int = 128
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy group-by-group quantization with diagonal-Hessian error
    feedback, each output column falling back to RTN where RTN does
    better on x_calib.  Returns (q (K, N) int8-held values, scales
    (K/group, N) f32)."""
    K, N = w.shape
    xf, wf = x_calib.float(), w.float()
    h = torch.mean(xf ** 2, dim=0) + 1e-6                          # (K,)
    qmax = 2 ** (bits - 1) - 1
    w_cur = wf.clone()
    qs, scales = [], []
    for g in range(K // group):
        lo, hi = g * group, (g + 1) * group
        blk, hblk = w_cur[lo:hi], h[lo:hi]
        scale = Q.absmax_scale(blk, dim=0, qmax=qmax)               # (1, N)
        qblk = torch.clamp(torch.round(blk / scale), -qmax, qmax)
        err = blk - qblk * scale
        # propagate the H-weighted mean error into the remaining rows
        corr = torch.sum(err * hblk[:, None], dim=0) / torch.sum(h)
        w_cur[hi:] -= corr[None]
        qs.append(qblk.to(torch.int8))
        scales.append(scale[0])
    q_fb, s_fb = torch.cat(qs), torch.stack(scales)
    q_rtn, s_rtn = Q.quantize_weight_grouped(wf, bits=bits, group=group)
    keep_fb = _col_err(q_fb, s_fb, xf, wf, group) <= \
        _col_err(q_rtn, s_rtn, xf, wf, group)                       # (N,)
    return (torch.where(keep_fb[None], q_fb, q_rtn),
            torch.where(keep_fb[None], s_fb, s_rtn))


def smoothquant_factor(x_calib: torch.Tensor, w: torch.Tensor,
                       alpha: float = 0.5) -> torch.Tensor:
    """SmoothQuant migration factor ``amax_x^α / amax_w^(1-α)`` per K."""
    ax = torch.clamp_min(x_calib.abs().amax(0), 1e-8)
    aw = torch.clamp_min(w.abs().amax(1), 1e-8)
    return (ax ** alpha) / (aw ** (1 - alpha))
