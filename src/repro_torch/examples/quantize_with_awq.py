"""Offline quantization pipeline: calibrate (AWQ) → quantize → pack →
evaluate, from a model trained in the port.  Port of
``examples/quantize_with_awq.py``:

  1. train a reduced model briefly on the synthetic corpus,
  2. collect calibration activations for the FFN inputs,
  3. AWQ-search the per-channel scale jointly over w1‖w3 (both consume
     the same activation), fold 1/s into the preceding RMSNorm gain,
  4. quantize + hardware-aware-pack the scaled weights (§4.1; on the card
     in the A16 kernel's fragment order),
  5. compare held-out loss: bf16 vs plain RTN-W4 vs AWQ-W4.

    python -m repro_torch.examples.quantize_with_awq
    python -m repro_torch.examples.quantize_with_awq --device cpu --steps 30
"""
import argparse


def main(argv=None) -> None:
    """Run the five steps; print the three held-out losses."""
    import torch

    from repro_torch.configs import get_reduced
    from repro_torch.core import calibration as CAL
    from repro_torch.core import quantize as Q
    from repro_torch.core.packing import pack_prequantized, to_kernel_layout
    from repro_torch.core.precision import get_policy
    from repro_torch.models.registry import build
    from repro_torch.training import data as D
    from repro_torch.training.loop import train

    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    dev = args.device

    cfg = get_reduced("smollm-360m")
    model = build(cfg)
    pol16, pol4 = get_policy("w16a16kv16"), get_policy("w4a16kv8")

    print(f"1. training a reduced model ({args.steps} steps)…")
    res = train(cfg, n_steps=args.steps, batch=8, seq=48, lr=2e-3,
                log_every=100, device=dev)
    params = res["params"]
    # A briefly trained reduced model has little quantization-sensitive
    # structure, so the degradations below are small; AWQ beating RTN is
    # asserted on a salient-channel problem in
    # tests/test_torch_calibration.py.  This walks the pipeline.

    print("2. collecting FFN calibration activations…")
    toks, _ = next(D.batches(cfg.vocab, 8, 48, 1, seed=99, device=dev))
    with torch.no_grad():
        h = model.hidden_states(params, toks, policy=pol16)
    # FFN input = rms_norm(x, ln2); approximated by the final hidden
    # states' distribution (it shares the salient-channel structure)
    x_calib = h.reshape(-1, cfg.d_model).float()[:256]

    def pack(q, s):
        p = pack_prequantized(q, s, bits=4, group=64, block_k=64,
                              block_n=128)
        return to_kernel_layout(p, "a16") if p.data.is_cuda else p

    @torch.no_grad()
    def quantize_ffn(use_awq: bool):
        """w1 / w3 of every layer to W4 (optionally AWQ-scaled)."""
        layers = []
        for lp in params["layers"]:
            a, b = lp["w1"].float(), lp["w3"].float()
            ln2 = lp["ln2"]
            if use_awq:
                s, _ = CAL.awq_search_scale(torch.cat([a, b], dim=1),
                                            x_calib, bits=4, group=64)
                a, b = a * s[:, None], b * s[:, None]
                # rms_norm scales by (1 + g): g' = (1 + g) / s − 1
                ln2 = ((1.0 + ln2.float()) / s - 1.0).to(ln2.dtype)
            layers.append({**lp, "ln2": ln2,
                           "w1": pack(*Q.quantize_weight_grouped(a, 4, 64)),
                           "w3": pack(*Q.quantize_weight_grouped(b, 4, 64))})
        return {**params, "layers": layers}

    @torch.no_grad()
    def held_out_loss(p):
        toks, tgts = next(D.batches(cfg.vocab, 8, 48, 1, seed=1234,
                                    device=dev))
        return float(model.loss_fn(p, pol4, toks, tgts))

    print("3-5. quantizing + evaluating…")
    loss_bf16 = held_out_loss(params)
    loss_rtn = held_out_loss(quantize_ffn(False))
    loss_awq = held_out_loss(quantize_ffn(True))
    print(f"\nheld-out loss  bf16: {loss_bf16:.4f}   RTN-W4: {loss_rtn:.4f}"
          f"   AWQ-W4: {loss_awq:.4f}")
    print(f"W4 degradation: RTN +{loss_rtn - loss_bf16:.4f}, "
          f"AWQ +{loss_awq - loss_bf16:.4f}")


if __name__ == "__main__":
    main()
