"""Training loop: one step = the registry's ``loss_fn``, its gradient by
autograd, then the optimizer.

Port of ``repro.training.loop``.  Training always runs w16a16kv16 (the
paper is inference-only; the same model code runs in bf16).  On the card
every attention call of the forward goes through the flash-prefill
kernel and its backward through the flash-prefill backward kernel
(``core.attention.flash_attention``); the GEMMs are ``torch.matmul``, as
the reference leaves them to XLA.  ``remat=True`` recomputes each layer's
activations in the backward pass (``torch.utils.checkpoint``), as the
reference's ``jax.checkpoint``.
"""
from __future__ import annotations

import time
from typing import Any, Callable, Dict, Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.precision import get_policy
from repro_torch.models.registry import Model, build

from . import checkpoint as CKPT
from . import data as D
from . import optimizer as O


def tree_map(fn: Callable, tree):
    """``fn`` over every tensor of nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v) for v in tree)
    return fn(tree)


def empty_state(model: Model, opt: O.Optimizer) -> Optional[Dict[str, Any]]:
    """The reference's leaves of a training state that the port's layout
    has no place for: the zero-length leaves of each layer stack with no
    layers and their optimizer state (``opt.init`` of them, without its
    step), in the reference's layout — ``checkpoint.save`` / ``restore``'s
    ``empty``.  None when every stack has layers."""
    empty = model.empty_stacks()
    if not empty:
        return None
    return {"params": empty, "opt": {k: v for k, v in opt.init(empty).items()
                                     if k != "step"}}


def make_train_step(model: Model, opt: O.Optimizer,
                    remat: bool = False) -> Callable:
    """``train_step(params, opt_state, tokens, targets, **extra) ->
    (params, opt_state, loss)``: the parameters (leaves requiring grad)
    are updated in place; ``loss`` is the step's detached scalar."""
    policy = get_policy("w16a16kv16")

    def train_step(params, opt_state, tokens, targets, **extra):
        def clear(p):
            p.grad = None
        tree_map(clear, params)
        loss = model.loss_fn(params, policy, tokens, targets, remat=remat,
                             **extra)
        loss.backward()
        grads = tree_map(lambda p: p.grad, params)
        params, opt_state = opt.update(grads, opt_state, params)
        return params, opt_state, loss.detach()

    return train_step


def train(cfg: ModelConfig, n_steps: int = 100, batch: int = 8,
          seq: int = 128, lr: float = 3e-4, seed: int = 0,
          log_every: int = 10, remat: bool = False,
          checkpoint_path: Optional[str] = None,
          checkpoint_every: int = 0, device="cuda") -> Dict[str, Any]:
    """Single-device training driver on the synthetic corpus: seeded
    random parameters on ``device``, the optimizer ``for_config`` picks,
    ``n_steps`` steps of (batch, seq) tokens.  Returns the parameters,
    the optimizer state, the logged ``(step, loss)`` pairs, the wall
    seconds, tokens per second and each step's wall seconds (host clock;
    on the card each step ends in a synchronize).  A checkpoint holds the
    reference's tree (``checkpoint``), so either package restores it."""
    model = build(cfg)
    params = tree_map(lambda p: p.requires_grad_(True),
                      model.init_params(seed, device))
    opt = O.for_config(cfg, lr=lr, total_steps=n_steps)
    opt_state = opt.init(params)
    extra = model.extra_inputs(seed + 7, batch, device)
    step_fn = make_train_step(model, opt, remat=remat)
    empty = empty_state(model, opt) if checkpoint_path else None
    cuda = torch.device(device).type == "cuda"

    losses, step_s = [], []
    t0 = time.perf_counter()
    for i, (toks, tgts) in enumerate(
            D.batches(cfg.vocab, batch, seq, n_steps, seed, device)):
        ts = time.perf_counter()
        params, opt_state, loss = step_fn(params, opt_state, toks, tgts,
                                          **extra)
        if cuda:
            torch.cuda.synchronize(device)
        step_s.append(time.perf_counter() - ts)
        if i % log_every == 0 or i == n_steps - 1:
            lv = float(loss)
            losses.append((i, lv))
            print(f"step {i:5d}  loss {lv:.4f}")
        if checkpoint_path and checkpoint_every and \
                (i + 1) % checkpoint_every == 0:
            CKPT.save(checkpoint_path, {"params": params, "opt": opt_state},
                      step=i + 1, empty=empty)
    dt = time.perf_counter() - t0
    return {"params": params, "opt_state": opt_state, "losses": losses,
            "wall_s": dt, "tokens_per_s": n_steps * batch * seq / dt,
            "step_s": step_s}
