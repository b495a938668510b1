#!/usr/bin/env python3
"""Time the kernels and the serves' GEMM device time of several trees of
this repository on one card, one tree after another in one run.

    python3 tools/compare_trees.py OLD NEW NEW OLD
        [--phases gemm,serve,attn,flash_bwd] [--out chiprun_out/compare.json]

Each TREE is a checkout of the repository (``.`` for this one).  Every
tree runs in a process of its own, with its own ``src/`` on the path and
its own ``build/`` directory, through its own ``chip_smoke.py``:

* ``gemm``: ``chip_smoke.gemm_phase`` — each GEMM row's kernel, plain and
  ``torch.matmul`` times (CUDA events, L2 flushed before every launch).
* ``attn`` (name it in ``--phases``): ``chip_smoke.attn_phase`` — the
  same for the decode-attention kernels (SDPA the yardstick); rows of
  equal shape compare across trees.
* ``flash_bwd`` (name it in ``--phases``): ``chip_smoke.flash_bwd_phase``
  — the flash backward at the training shapes (SDPA's backward the
  yardstick), checked against its plain version in every tree.
* ``serve``: full-width serves on the dense slab with 4 slots, each after
  a warm-up request, under ``torch.profiler``: recurrentgemma-2b w4a16kv8
  (4 requests of 128-token prompts, 8 new tokens), whisper-tiny w4a16kv8
  (16-token prompts) and smollm-360m w4a8kv4 (32-token prompts): wall,
  device busy, and the device time and count of each GEMM kernel.

Prints each run's rows, then every kernel row side by side across the
trees, and writes them all to ``--out``.
"""
import argparse
import json
import os
import re
import subprocess
import sys
from pathlib import Path

#: profiler kernel names of each GEMM, in both designs
GEMM_NAMES = {"mpgemm_a16": r"mpgemm_a16_kernel|gemm_kernel<false",
              "mpgemm_int8": r"mpgemm_int8_kernel|gemm_kernel<true"}


def serve_profile(arch, policy, max_seq, n_req, prompt_len, new_tokens):
    """One profiled serve of ``arch`` on the dense slab (4 slots)."""
    import time

    import numpy as np
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.configs import get_config
    from repro_torch.serving import Engine, EngineConfig, SamplingParams
    cfg = get_config(arch)
    eng = Engine(EngineConfig(model=cfg, policy=policy, n_slots=4,
                              max_seq=max_seq, seed=0, device="cuda"))
    prompts = np.random.default_rng(0).integers(
        1, cfg.vocab, (n_req, prompt_len)).tolist()
    eng.generate(prompts[:1], SamplingParams(max_new_tokens=2))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        steps0 = eng.model_steps
        eng.generate(prompts, SamplingParams(max_new_tokens=new_tokens))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        steps = eng.model_steps - steps0
    busy, gemm = 0.0, {k: [0.0, 0] for k in GEMM_NAMES}
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        us = e.time_range.elapsed_us()
        busy += us
        for k, pat in GEMM_NAMES.items():
            if re.search(pat, e.name):
                gemm[k][0] += us / 1e3
                gemm[k][1] += 1
    del eng
    torch.cuda.empty_cache()
    return dict(arch=arch, policy=policy, steps=steps, wall_ms=wall * 1e3,
                ms_per_step=wall * 1e3 / steps,
                tokens_per_s=n_req * new_tokens / wall,
                device_busy_ms=busy / 1e3,
                gemm_ms={k: v[0] for k, v in gemm.items()},
                gemm_calls={k: v[1] for k, v in gemm.items()})


def worker(tree, phases):
    """Run ``phases`` with ``tree``'s code; return the results."""
    tree = Path(tree).resolve()
    sys.path[:0] = [str(tree / "src"), str(tree)]
    import torch

    import chip_smoke
    from repro_torch.kernels import _build
    _build.build_all()
    torch.backends.cuda.matmul.allow_tf32 = False
    out = dict(tree=str(tree))
    kernel_phases = {"gemm": chip_smoke.gemm_phase,
                     "attn": chip_smoke.attn_phase,
                     "flash_bwd": chip_smoke.flash_bwd_phase}
    if kernel_phases.keys() & set(phases):
        flush = torch.empty(1 << 30, dtype=torch.uint8, device="cuda")
        for _ in range(1000):                 # clocks up
            flush.zero_()
        torch.cuda.synchronize()
        for name, phase in kernel_phases.items():
            if name in phases:
                out[name] = phase(torch.device("cuda"), flush)
        del flush
    if "serve" in phases:
        out["serve"] = [
            serve_profile("recurrentgemma-2b", "w4a16kv8", 512, 4, 128, 8),
            serve_profile("whisper-tiny", "w4a16kv8", 256, 4, 16, 8),
            serve_profile("smollm-360m", "w4a8kv4", 256, 4, 32, 8)]
    return out


def print_side_by_side(trees, runs):
    """Each kernel row's µs in every tree, in the order given, and each
    tree's time over the first tree's."""
    times = {}
    for run in runs:
        for phase in ("gemm", "attn", "flash_bwd"):
            for kern, rows in run.get(phase, {}).items():
                for r in rows:
                    times.setdefault((kern, r["shape"]), []).append(r["ms"])
    print("side by side (us):", " | ".join(t[-24:] for t in trees))
    for (kern, shape), ms in times.items():
        print(f"  {kern:12s} {shape:58s} " + " ".join(
            f"{m * 1e3:8.1f}" for m in ms) + "  ratio " + " ".join(
            f"{m / ms[0]:.3f}" for m in ms))


def main():
    """Run each tree given on the command line (or, with ``--worker``, be
    the process of one tree); return the exit code."""
    ap = argparse.ArgumentParser()
    ap.add_argument("trees", nargs="*")
    ap.add_argument("--phases", default="gemm,serve")
    ap.add_argument("--out", default="chiprun_out/compare.json")
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        res = worker(args.worker, args.phases.split(","))
        print("RESULT " + json.dumps(res))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    runs = []
    for tree in args.trees:
        proc = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker", tree,
             "--phases", args.phases], capture_output=True, text=True)
        line = [ln for ln in proc.stdout.splitlines()
                if ln.startswith("RESULT ")]
        if proc.returncode or not line:
            print(proc.stdout[-4000:], proc.stderr[-4000:])
            return 1
        res = json.loads(line[-1][len("RESULT "):])
        res["card"] = smi
        runs.append(res)
        print(json.dumps({"tree": tree, "serve": res.get("serve")}))
        kern_rows = {**res.get("gemm", {}), **res.get("attn", {}),
                     **res.get("flash_bwd", {})}
        for kern, rows in kern_rows.items():
            for r in rows:
                lib = r["library_ms"]
                print(f"  {tree[-24:]:24s} {kern:12s} {r['shape']:58s} "
                      f"{r['ms'] * 1e3:7.1f} us  lib "
                      f"{'-' if lib is None else f'{lib * 1e3:.1f}'}  "
                      f"bound {r['bound_ms'] * 1e3:.2f}")
    print_side_by_side(args.trees, runs)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(runs))
    return 0


if __name__ == "__main__":
    sys.exit(main())
