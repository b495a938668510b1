"""Quickstart: the TurboMind-style mixed-precision pipeline in one page.
Port of ``examples/quickstart.py``.

    python -m repro_torch.examples.quickstart
    python -m repro_torch.examples.quickstart --device cpu

Walks the paper's two pipelines end to end:
  1. GEMM pipeline — offline hardware-aware weight packing (§4.1; on the
     card in the A16 kernel's fragment order), then the online
     mixed-precision matmul with fused dequantization.
  2. Attention pipeline — a quantized KV cache (§4.2/§4.4): prefill writes
     low-bit K/V, decode attends against them without ever materializing
     bf16 KV in memory.
The last lines hold the hand-written kernels (``csrc/mpgemm.cu``,
``csrc/kvattn.cu``) against the plain PyTorch paths; on the CPU the
wrappers run their plain versions.
"""
import argparse


def main(argv=None) -> dict:
    """Run both pipelines; print the reference's lines and return the
    kernel-versus-plain differences with the scale each is relative to."""
    import torch

    from repro_torch.core import (attention, dense_matmul, get_policy,
                                  init_cache, mp_matmul, pack_weight)
    from repro_torch.core.kvcache import append
    from repro_torch.core.packing import to_kernel_layout
    from repro_torch.kernels import ops as kops

    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = torch.device(args.device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    # ------------------------------------------------------------ GEMM --
    policy = get_policy("w4a16kv8")          # the paper's headline format
    print(f"policy: {policy.name}  (weights {policy.weights.bits}-bit, "
          f"acts {policy.acts.bits}-bit, kv {policy.kv.bits}-bit)")

    w = randn(2048, 2048) * 0.02
    packed = pack_weight(w, bits=4, group=128)       # OFFLINE: §4.1 packing
    if dev.type == "cuda":                           # the kernel's layout
        packed = to_kernel_layout(packed, "a16")
    print(f"packed storage: {packed.storage_bytes / w.numel():.2f} "
          f"bytes/value (bf16 would be 2.0)")

    x = randn(4, 2048).to(torch.bfloat16)
    y_mp = mp_matmul(x, packed, policy)              # ONLINE: fused dequant
    y_ref = dense_matmul(x, w)
    err = (y_mp.float() - y_ref.float()).abs().max().item()
    print(f"mixed-precision GEMM max err vs dense: {err:.4f}")

    # ------------------------------------------------------- attention --
    B, S, H, Hkv, D = 2, 512, 8, 2, 128
    cache = init_cache(B, S, Hkv, D, policy.kv, device=dev).layer(0)
    k_new = randn(B, S, Hkv, D).to(torch.bfloat16)
    v_new = randn(B, S, Hkv, D).to(torch.bfloat16)
    cache = append(cache, k_new, v_new, 0, policy.kv)   # prefill: quantize
    print(f"KV cache dtype: {cache.k.dtype}, per-(token,head) scales: "
          f"{tuple(cache.k_scale.shape)}")

    q = randn(B, 1, H, D).to(torch.bfloat16)
    out = attention.decode_attention(q, cache, policy.kv, pos=S - 1)
    print(f"decode attention out: {tuple(out.shape)} {out.dtype}")

    # the hand-written kernels (on the CPU: their plain versions)
    out_k = kops.kvattn_decode(q, cache, policy.kv, S - 1)
    attn_diff = (out.float() - out_k.float()).abs().max().item()
    print(f"kernel max diff vs plain path: {attn_diff:.5f}")
    y_naive = mp_matmul(x, packed, policy, impl="naive")
    gemm_diff = (y_mp.float() - y_naive.float()).abs().max().item()
    print(f"GEMM kernel max diff vs plain path: {gemm_diff:.5f}")
    return {"attn_diff": attn_diff,
            "attn_scale": out.float().abs().max().item(),
            "gemm_diff": gemm_diff,
            "gemm_scale": y_naive.float().abs().max().item()}


if __name__ == "__main__":
    main()
