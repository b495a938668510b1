#!/usr/bin/env python3
"""How far full-size rwkv6-7b's logits move with the batch a request is
decoded in, and why, on one card.

    python3 tools/rwkv6_batch_sensitivity.py [--new 16]
        [--out chiprun_out/rwkv6_batch.json]

Serves 4 requests of 129-token prompts on the full-size model (seeded
random weights, w4a16kv8, 4 slots), then replays request 0 teacher-forced
three ways: alone (B 1) twice, and with the serve's batch (B 4, lockstep,
``chip_smoke.lockstep_teacher_forced``).  Prints, per decode step, the
largest logit difference relative to the largest logit:

* ``alone_vs_alone`` — is one replay repeatable bit for bit;
* ``alone_vs_batch`` — the gap the batch count opens;
* ``f64_alone_vs_batch`` — the same with every ``torch.einsum`` (the wkv
  products of prefill and decode) computed in f64 and rounded to f32
  once, so the batch count no longer changes their sums;
* ``f64_vs_f32_alone`` — how far that precision change alone moves them.

Also checks that one decode step's GEMM inputs and outputs, its norms,
and the GEMM kernels at rwkv6's shapes give row 0 the same bits at B 1
and B 4 (``batch_independent``).  Needs one CUDA device.
"""
import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _gap(a, b):
    return [(x - y).abs().max().item() / y.abs().max().item()
            for x, y in zip(a, b)]


def batch_independent(eng, prompt, dev):
    """One decode step from the same prefilled state at B 1 and at B 4
    (four copies): every packed GEMM's row-0 input and output, and the
    logits, bit for bit?  And each GEMM kernel at rwkv6's shapes alone."""
    import torch
    from repro_torch.core.packing import pack_weight, to_kernel_layout
    from repro_torch.kernels.mpgemm import mpgemm_a16
    from repro_torch.models import rwkv6 as R
    model, pol, params = eng.model, eng.policy, eng.params
    st1 = model.init_cache(pol, 1, eng.max_seq, dev)
    _, st1 = model.prefill(params, pol, torch.tensor([prompt[:-1]],
                                                     device=dev), st1)
    st4 = model.init_cache(pol, 4, eng.max_seq, dev)
    for a, v in ((st4.tm_shift, st1.tm_shift), (st4.cm_shift, st1.cm_shift),
                 (st4.wkv, st1.wkv)):
        a.copy_(v.expand_as(a))
    calls = []
    linear = R.C.linear

    def spy(x, w, policy=None):
        y = linear(x, w, policy)
        calls.append((x[0].clone(), y[0].clone()))
        return y

    tok = torch.tensor([[prompt[-1]]], device=dev)
    R.C.linear = spy
    try:
        l1, _ = model.decode_step(params, pol, tok, st1, 0)
        c1, calls = calls, []
        l4, _ = model.decode_step(params, pol, tok.expand(4, 1).contiguous(),
                                  st4, 0)
    finally:
        R.C.linear = linear
    first = next((i for i, ((x1, y1), (x4, y4)) in enumerate(zip(c1, calls))
                  if not (torch.equal(x1, x4) and torch.equal(y1, y4))), None)
    kernels = {}
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    for K, N, bk, bn in ((4096, 4096, 128, 128), (4096, 14336, 128, 128),
                         (14336, 4096, 128, 128), (4096, 64, 128, 64),
                         (64, 4096, 64, 128)):
        w = torch.randn(K, N, generator=gen, device=dev) / K ** 0.5
        pw = to_kernel_layout(pack_weight(w, bits=4, group=bk, block_k=bk,
                                          block_n=bn), "a16")
        x = torch.randn(1, K, generator=gen, device=dev).to(torch.bfloat16)
        kernels[f"{K}x{N}"] = torch.equal(
            mpgemm_a16(x, pw), mpgemm_a16(x.expand(4, K).contiguous(),
                                          pw)[:1])
    return dict(first_gemm_call_differing=first, gemm_calls=len(c1),
                logits_equal=torch.equal(l1[0], l4[0]),
                logits_rel=(l4[0].float() - l1[0].float()).abs().max().item()
                / l1.float().abs().max().item(),
                kernels_m1_vs_m4_equal=kernels)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--new", type=int, default=16)
    ap.add_argument("--out", default="chiprun_out/rwkv6_batch.json")
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("rwkv6_batch_sensitivity: needs a CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    sys.path.insert(0, str(ROOT))
    import chip_smoke as CS
    from repro_torch.configs import get_config
    from repro_torch.serving import Engine, EngineConfig, SamplingParams
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda")
    cfg = get_config("rwkv6-7b")
    eng = Engine(EngineConfig(model=cfg, policy="w4a16kv8", n_slots=4,
                              max_seq=256, seed=0, device=dev))
    prompts = np.random.default_rng(0).integers(1, cfg.vocab,
                                                (4, 129)).tolist()
    eng.generate(prompts[:1], SamplingParams(max_new_tokens=2))
    outs = eng.generate(prompts, SamplingParams(max_new_tokens=args.new))

    def alone():
        stream = prompts[0] + outs[0].output_token_ids[:-1]
        return CS.one_shot_teacher_forced(eng.model, eng.params, eng.policy,
                                          stream, 128, {}, eng.max_seq,
                                          dev)[1:]

    a1, a2 = alone(), alone()
    lock = CS.lockstep_teacher_forced(eng, prompts, outs)[0]
    res = dict(alone_vs_alone=_gap(a1, a2), alone_vs_batch=_gap(a1, lock),
               served_is_batch_argmax=[int(lg.argmax()) for lg in lock]
               == outs[0].output_token_ids)
    einsum = torch.einsum
    torch.einsum = lambda eq, *ops: einsum(
        eq, *[o.double() for o in ops]).float()
    try:
        b1 = alone()
        b4 = CS.lockstep_teacher_forced(eng, prompts, outs)[0]
    finally:
        torch.einsum = einsum
    res.update(f64_alone_vs_batch=_gap(b1, b4), f64_vs_f32_alone=_gap(b1, a1),
               batch_independent=batch_independent(eng, prompts[0], dev))
    for k, v in res.items():
        print(f"{k}: {json.dumps(v)}")
    out = ROOT / args.out
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text(json.dumps(res, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
