"""Train a small model for a few hundred steps on the synthetic corpus —
exercises the full training substrate (data pipeline → model → optimizer
→ checkpoint).  Port of ``examples/train_small.py``.  The reduced config
keeps this CPU-feasible (``--device cpu``); pass ``--arch`` / ``--steps``
to scale up on the card.

    python -m repro_torch.examples.train_small --steps 200
    python -m repro_torch.examples.train_small --device cpu --steps 20
"""
import argparse
import os
import tempfile


def main(argv=None) -> None:
    """Train the REDUCED ``--arch``; print the loss before and after and
    the checkpoint's path."""
    from repro_torch.configs import ARCHS, get_reduced
    from repro_torch.training.loop import train

    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=ARCHS)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--lr", type=float, default=2e-3)
    ap.add_argument("--checkpoint", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train_small.npz"))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    cfg = get_reduced(args.arch)
    print(f"training {cfg.name} ({cfg.n_layers}L d={cfg.d_model}) "
          f"for {args.steps} steps on {args.device}")
    res = train(cfg, n_steps=args.steps, batch=args.batch, seq=args.seq,
                lr=args.lr, log_every=20, checkpoint_path=args.checkpoint,
                checkpoint_every=max(1, min(50, args.steps // 4)),
                device=args.device)
    first, last = res["losses"][0][1], res["losses"][-1][1]
    print(f"\nloss {first:.3f} → {last:.3f}  "
          f"({res['tokens_per_s']:.0f} tokens/s on {args.device})")
    print(f"checkpoint: {args.checkpoint}")


if __name__ == "__main__":
    main()
