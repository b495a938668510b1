"""Training driver on one device.

Port of ``repro.launch.train``: the same flags, one device.  Trains the
full configuration on the card unless ``--reduced`` (the REDUCED config,
CPU-feasible) and ``--device cpu`` (tests).  The reference's
``--devices`` / ``--mesh`` (a data × model mesh under pjit) are
multi-device launch code, not yet ported: ROADMAP queue 1 item 12.

Usage:
    python -m repro_torch.launch.train --arch smollm-360m --steps 100 \\
        --batch 8 --seq 128
    python -m repro_torch.launch.train --arch whisper-tiny --reduced \\
        --device cpu --steps 4 --seq 16
"""
import argparse
import sys


def main(argv=None) -> int:
    """Train ``--steps`` steps on the synthetic corpus; print the losses,
    tokens/s and, with ``--checkpoint``, where the checkpoint went."""
    from repro_torch.configs import ARCHS
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-360m", choices=ARCHS)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--reduced", action="store_true",
                    help="train the reduced config (CPU-feasible)")
    ap.add_argument("--devices", type=int, default=0,
                    help="multi-device: not yet ported (ROADMAP item 12)")
    ap.add_argument("--mesh", default="",
                    help="multi-device: not yet ported (ROADMAP item 12)")
    ap.add_argument("--checkpoint", default="")
    ap.add_argument("--remat", action="store_true")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.devices or args.mesh:
        raise NotImplementedError(
            "--devices / --mesh (a data x model mesh) are multi-device "
            "launch code, not yet ported: ROADMAP queue 1 item 12")

    from repro_torch.configs import get_config, get_reduced
    from repro_torch.training.loop import train

    cfg = get_reduced(args.arch) if args.reduced else get_config(args.arch)
    print(f"device {args.device}, arch {cfg.name}")
    res = train(cfg, n_steps=args.steps, batch=args.batch, seq=args.seq,
                lr=args.lr, log_every=10, remat=args.remat,
                checkpoint_path=args.checkpoint or None,
                checkpoint_every=args.steps if args.checkpoint else 0,
                device=args.device)
    print(f"done: {args.steps} steps, {res['tokens_per_s']:.0f} tokens/s")
    if args.checkpoint:
        print("checkpoint:", args.checkpoint)
    return 0


if __name__ == "__main__":
    sys.exit(main())
