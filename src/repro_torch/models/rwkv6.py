"""RWKV6 ("Finch", arXiv:2404.05892) — the ssm family: an attention-free
linear recurrence with data-dependent decay.

Port of ``repro.models.rwkv6`` (prefill, decode and the training
forward).  The wkv recurrence
per head (state S ∈ R^{dk×dv}):

    S_t = diag(w_t) · S_{t-1} + k_tᵀ v_t
    y_t = r_t · (S_{t-1} + (u ⊙ k_t)ᵀ v_t)

with the per-channel log-decay ``log w_t = -sigmoid(w0 + tanh(x_w A) B)``
from a 64-wide LoRA on the token-shifted input.  Prefill runs the chunked
GLA form (chunk 64: the intra-chunk part as a masked (C×C) product with
factorized decay ratios, the state carried across chunks by a Python loop
where the reference scans); decode is the O(1)-state recurrence.  Every
projection, the LoRA's two products included, goes through
:func:`common.linear` — the mixed-precision GEMM kernels when packed.  The
recurrence itself is plain PyTorch, as the reference's is XLA outside any
Pallas kernel.

As in the reference, the chunked form takes a sequence of fewer than 64
tokens or a multiple of 64 (``repro/models/rwkv6.py:133``), in prefill and
in training alike; other lengths are refused (:func:`check_prefill_len`)
rather than padded, since padding tokens would enter the recurrent
state.  Parameters are a dict whose
``"layers"`` entry is a list of per-layer dicts (the JAX package stacks
them for its layer scan).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ModelConfig
from repro_torch.core import attention as A
from repro_torch.core.precision import PrecisionPolicy, get_policy

from . import common as C
from .transformer import lm_logits

CHUNK = 64
LORA = 64


@dataclasses.dataclass
class RWKVState:
    """Decode state: batch on axis 1 of every leaf (the engine splices a
    B=1 prefill state into a slot along it)."""

    tm_shift: torch.Tensor   # (L, B, d) bf16: last token seen by time-mix
    cm_shift: torch.Tensor   # (L, B, d) bf16: last token seen by channel-mix
    wkv: torch.Tensor        # (L, B, H, dh, dh) f32 recurrent state


def init_state(cfg: ModelConfig, batch: int, device="cuda") -> RWKVState:
    """Zero state for ``batch`` sequences."""
    L, d, dh = cfg.n_layers, cfg.d_model, cfg.rwkv_head_dim
    return RWKVState(
        tm_shift=torch.zeros((L, batch, d), dtype=torch.bfloat16,
                             device=device),
        cm_shift=torch.zeros((L, batch, d), dtype=torch.bfloat16,
                             device=device),
        wkv=torch.zeros((L, batch, d // dh, dh, dh), dtype=torch.float32,
                        device=device))


def state_spec(cfg: ModelConfig, batch: int) -> RWKVState:
    """:func:`init_state` with no storage (meta tensors): the dry-run's
    stand-in."""
    return init_state(cfg, batch, device="meta")


def init_params(cfg: ModelConfig, seed: int = 0,
                device="cuda") -> Dict[str, Any]:
    """Seeded random parameters of the JAX package's leaves (lerp
    coefficients 0.5, norm gains zero and ``ln_x`` one, LoRA scale 0.01,
    ``u`` 0.5, embed and head 0.02), drawn on ``device`` from one
    ``torch.Generator`` (other values than JAX's for the same seed; tests
    carry JAX's across with ``params_from_jax``)."""
    d, f, dh = cfg.d_model, cfg.d_ff, cfg.rwkv_head_dim
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)

    def full(value, shape=(d,)):
        return torch.full(shape, value, dtype=torch.bfloat16, device=device)

    layers = []
    for _ in range(cfg.n_layers):
        lp = {"ln1": full(0.0), "ln2": full(0.0), "w0": full(0.0),
              "ln_x": full(1.0)}
        for mu in ("mu_r", "mu_k", "mu_v", "mu_w", "mu_g", "mu_ck",
                   "mu_cr"):
            lp[mu] = full(0.5)
        for name in ("wr", "wk", "wv", "wg", "wo", "cr"):
            lp[name] = C.dense_init(gen, (d, d))
        lp["w_A"] = C.dense_init(gen, (d, LORA), scale=0.01)
        lp["w_B"] = C.dense_init(gen, (LORA, d), scale=0.01)
        lp["u"] = C.dense_init(gen, (d // dh, dh), scale=0.5)
        lp["ck"] = C.dense_init(gen, (d, f))
        lp["cv"] = C.dense_init(gen, (f, d))
        layers.append(lp)
    return {
        "embed": C.dense_init(gen, (cfg.vocab, d), scale=0.02),
        "layers": layers,
        "final_norm": full(0.0),
        "lm_head": C.dense_init(gen, (d, cfg.vocab), scale=0.02),
    }


def check_prefill_len(S: int, training: bool = False) -> None:
    """Raise ``ValueError`` unless the chunked form takes ``S`` tokens:
    fewer than 64, or a multiple of 64 (the reference asserts the same,
    ROADMAP §3)."""
    if not (S % CHUNK == 0 or S < CHUNK):
        what = (f"trains on sequences of {S} tokens" if training else
                f"prefills {S} tokens")
        hint = "" if training else "; a prompt of n tokens prefills n - 1"
        raise ValueError(
            f"rwkv6 {what}, but its chunked wkv form takes fewer than "
            f"{CHUNK} tokens or a multiple of {CHUNK} (as the reference)"
            f"{hint}")


def _lerp(x, x_prev, mu):
    """Token-shift interpolation in x's dtype, as written."""
    return x + (x_prev - x) * mu.to(x.dtype)


def _log_decay(xw, lp, policy):
    """``-sigmoid(w0 + tanh(xw @ w_A) @ w_B)`` in f32, ∈ (-1, 0)."""
    a = C.linear(xw, lp["w_A"], policy)
    w_raw = C.linear(torch.tanh(a.float()).to(xw.dtype), lp["w_B"], policy)
    return -torch.sigmoid(w_raw.float() + lp["w0"].float())


# ---------------------------------------------------------------------------
# Chunked GLA wkv (prefill)
# ---------------------------------------------------------------------------


def _wkv_chunked(r, k, v, logw, u, s0) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v, logw: (B, S, H, dh); u: (H, dh); s0: (B, H, dh, dh).
    Returns (y (B, S, H, dh) f32, final state f32)."""
    B, S, H, dh = r.shape
    check_prefill_len(S)
    Cn = min(CHUNK, S)
    n = S // Cn
    rs, ks, vs = (t.reshape(B, n, Cn, H, dh).float() for t in (r, k, v))
    lw = logw.reshape(B, n, Cn, H, dh)
    u = u.float()
    mask = torch.tril(torch.ones((Cn, Cn), dtype=torch.bool,
                                 device=r.device), diagonal=-1)
    s = s0.float()
    ys = []
    for c in range(n):
        rc, kc, vc, lwc = rs[:, c], ks[:, c], vs[:, c], lw[:, c]
        la = A.cumsum(lwc, 1)                      # log A_i (inclusive)
        a_prev = torch.exp(la - lwc)               # A_{i-1}
        a_end = torch.exp(la[:, -1:])              # A_C, (B, 1, H, dh)
        r_t = rc * a_prev                          # r~_i
        k_t = kc * torch.exp(-la)                  # k~_j = k_j / A_j
        # inter-chunk: y_i += r~_i @ S0
        y = A.einsum("bchd,bhde->bche", r_t, s)
        # intra-chunk: strictly lower triangular
        scores = A.einsum("bchd,bkhd->bhck", r_t, k_t)
        scores = scores.masked_fill(~mask, 0.0)
        y = y + A.einsum("bhck,bkhe->bche", scores, vc)
        # diagonal (current-token bonus u)
        diag = A.einsum("bchd,bchd->bch", rc, u[None, None] * kc)
        y = y + diag[..., None] * vc
        # S' = diag(A_C) S + Σ_j (A_C / A_j ⊙ k_j)ᵀ v_j
        kd = kc * torch.exp(la[:, -1:] - la)       # ratios ≤ 1
        s = a_end[:, 0, :, :, None] * s + A.einsum("bchd,bche->bhde",
                                                       kd, vc)
        ys.append(y)
    return torch.stack(ys, dim=1).reshape(B, S, H, dh), s


def _shifted(x, x_prev_last):
    """x (B, S, d) shifted one token right, the state's last token first."""
    return torch.cat([x_prev_last[:, None].to(x.dtype), x[:, :-1]], dim=1)


def _time_mix_seq(x, x_prev_last, lp, cfg: ModelConfig, policy, s0):
    """Full-sequence time-mix.  x: (B, S, d); x_prev_last: (B, d).
    Returns (output, new time-mix shift, new wkv state)."""
    B, S, d = x.shape
    dh = cfg.rwkv_head_dim
    H = d // dh
    xs = _shifted(x, x_prev_last)

    def proj(name, mu):
        return C.linear(_lerp(x, xs, lp[mu]), lp[name], policy)

    r = C.constrain_heads(C.split_heads(proj("wr", "mu_r"), B, S, H, dh))
    k = C.constrain_heads(C.split_heads(proj("wk", "mu_k"), B, S, H, dh))
    v = C.constrain_heads(C.split_heads(proj("wv", "mu_v"), B, S, H, dh))
    g = F.silu(proj("wg", "mu_g").float())
    logw = C.constrain_heads(_log_decay(_lerp(x, xs, lp["mu_w"]), lp,
                                        policy).reshape(B, S, H, dh))
    y, s_fin = _wkv_chunked(r, k, v, logw, lp["u"], s0)
    y = C.group_norm(C.merge_heads(y, B, S, d).to(x.dtype), lp["ln_x"], H)
    y = (y.float() * g).to(x.dtype)
    return C.linear(y, lp["wo"], policy), x[:, -1], s_fin


def _channel_mix(x, xs, lp, policy):
    """Channel-mix of x against its shifted copy xs (any leading dims)."""
    kx = _lerp(x, xs, lp["mu_ck"])
    rx = _lerp(x, xs, lp["mu_cr"])
    kk = torch.square(F.relu(C.linear(kx, lp["ck"], policy).float())
                      ).to(x.dtype)
    rr = torch.sigmoid(C.linear(rx, lp["cr"], policy).float())
    return (rr * C.linear(kk, lp["cv"], policy).float()).to(x.dtype)


# ---------------------------------------------------------------------------
# Full-sequence forward (prefill)
# ---------------------------------------------------------------------------


def _forward_seq(params, cfg: ModelConfig, tokens, policy,
                 state: RWKVState, remat: bool = False
                 ) -> Tuple[torch.Tensor, RWKVState]:
    """tokens (B, S) from ``state`` → (final-normed hidden states, the new
    state); ``remat`` recomputes each layer in the backward pass."""
    x = C.embed_rows(params["embed"], tokens).to(policy.compute_dtype)

    def body(x, lp, tm_s, cm_s, wkv_s):
        h = C.rms_norm(x, lp["ln1"], cfg.norm_eps)
        dx, tm_new, wkv_new = _time_mix_seq(h, tm_s, lp, cfg, policy, wkv_s)
        x = x + dx
        h2 = C.rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + _channel_mix(h2, _shifted(h2, cm_s), lp, policy)
        return x, tm_new, h2[:, -1], wkv_new

    tm, cm, wkv = [], [], []
    for i, lp in enumerate(params["layers"]):
        args = (x, lp, state.tm_shift[i], state.cm_shift[i], state.wkv[i])
        x, tm_new, cm_new, wkv_new = checkpoint(
            body, *args, use_reentrant=False) if remat else body(*args)
        tm.append(tm_new)
        cm.append(cm_new)
        wkv.append(wkv_new)
    new_state = RWKVState(tm_shift=torch.stack(tm), cm_shift=torch.stack(cm),
                          wkv=torch.stack(wkv))
    return C.rms_norm(x, params["final_norm"], cfg.norm_eps), new_state


def hidden_states(params, cfg: ModelConfig, tokens: torch.Tensor,
                  policy: Optional[PrecisionPolicy] = None,
                  remat: bool = False) -> torch.Tensor:
    """tokens (B, S) → final normed hidden states (B, S, d) from a zero
    state: the training forward.  S must be < 64 or a multiple of 64."""
    check_prefill_len(tokens.shape[1], training=True)
    policy = policy or get_policy("w16a16kv16")
    state = init_state(cfg, tokens.shape[0], tokens.device)
    h, _ = _forward_seq(params, cfg, tokens, policy, state, remat=remat)
    return h


def prefill(params, cfg: ModelConfig, policy: PrecisionPolicy,
            tokens: torch.Tensor, state: RWKVState
            ) -> Tuple[torch.Tensor, RWKVState]:
    """tokens (B, S) from ``state`` → (last-position logits (B, V), the
    state after them).  S must be < 64 or a multiple of 64."""
    h, state = _forward_seq(params, cfg, tokens, policy, state)
    return lm_logits(params, h[:, -1]), state


# ---------------------------------------------------------------------------
# Decode (O(1) state per token)
# ---------------------------------------------------------------------------


def decode_step(params, cfg: ModelConfig, policy: PrecisionPolicy,
                tokens: torch.Tensor, state: RWKVState, pos=None
                ) -> Tuple[torch.Tensor, RWKVState]:
    """tokens (B, 1) → ((B, V) logits, the new state).  ``pos`` is unused:
    the state is positional."""
    x = C.embed_rows(params["embed"], tokens[:, 0]).to(policy.compute_dtype)
    B, d = x.shape
    dh = cfg.rwkv_head_dim
    H = d // dh
    tm, cm, wkv = [], [], []
    for i, lp in enumerate(params["layers"]):
        tm_s, cm_s, wkv_s = state.tm_shift[i], state.cm_shift[i], \
            state.wkv[i]
        h = C.rms_norm(x, lp["ln1"], cfg.norm_eps)

        def proj(name, mu):
            return C.linear(_lerp(h, tm_s, lp[mu]), lp[name], policy)

        r = C.split_heads(proj("wr", "mu_r"), B, H, dh).float()
        k = C.split_heads(proj("wk", "mu_k"), B, H, dh).float()
        v = C.split_heads(proj("wv", "mu_v"), B, H, dh).float()
        g = F.silu(proj("wg", "mu_g").float())
        logw = _log_decay(_lerp(h, tm_s, lp["mu_w"]), lp, policy).reshape(
            B, H, dh)
        u = lp["u"].float()
        # y = r·(S + (u⊙k)ᵀ v);  S' = diag(w)·S + kᵀ v
        kv = A.einsum("bhd,bhe->bhde", k, v)
        y = A.einsum("bhd,bhde->bhe", r, wkv_s + u[None, :, :, None] * kv)
        wkv.append(torch.exp(logw)[..., None] * wkv_s + kv)
        y = C.group_norm(y.reshape(B, d).to(x.dtype), lp["ln_x"], H)
        y = (y.float() * g).to(x.dtype)
        x = x + C.linear(y, lp["wo"], policy)
        tm.append(h)
        h2 = C.rms_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + _channel_mix(h2, cm_s.to(h2.dtype), lp, policy)
        cm.append(h2)
    new_state = RWKVState(tm_shift=torch.stack(tm), cm_shift=torch.stack(cm),
                          wkv=torch.stack(wkv))
    h_last = C.rms_norm(x, params["final_norm"], cfg.norm_eps)
    return lm_logits(params, h_last), new_state
