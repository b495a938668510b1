#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and check it.

    python3 chip_smoke.py

Phases, in order (any failure raises and exits nonzero):

1. Print the card's name and power limit (``nvidia-smi``).
2. Build every CUDA kernel of the port from ``src/repro_torch/csrc`` with
   ``nvcc`` for ``sm_90a`` (one compiler per source, in parallel); print
   each function's registers and spills, and fail if a flash-prefill
   kernel at head dim 288 or any backward function spills.
3. Kernel phase: hold each kernel against its plain PyTorch version on the
   card at the main paths' full-width shapes — both GEMMs at bits 4 and 8
   at smollm-360m's and recurrentgemma-2b's packed shapes, the weights in
   the kernels' fragment order, paged and dense-slab attention in every KV
   format (smollm-360m), flash prefill at recurrentgemma-2b's local
   attention (S 127 and 4096, window 2048, D 256, 10 query heads on one
   KV head), whisper-tiny's encoder (S 1500, non-causal, D 64) and its
   decoder prompt (S 15, causal, D 64), at the tile its wrapper picks —
   on peaked inputs (a few keys carry each row), and time kernel, plain
   version and a library yardstick with CUDA events, L2 flushed before
   every launch; flash prefill is timed at every tile its wrapper can
   pick.  Each row's bound divides the work the kernel's wrapper declares
   to a ``roofline.op_cost`` counter (``kernels.cost.OF``) by the card's
   peaks (``roofline.analysis.HW``).  The dense and paged attention
   kernels must agree bit for bit, and a 32-token chunk's rows must be
   the bits of the same tokens fed
   one at a time and of each slot served alone.  The same for the tiles
   too large to stage whole, walked as sub-tiles (``SUB_TILES``: the
   max_seq-500 slab tile, a 512-token pool block at kv16, 256-token tiles
   at D 128), and for gemma3-1b's head dim 288 (``D288_CASES``: every
   format, T 1 and T 32 against window 1024, a global layer, a sub-tiled
   kv16 block).  Both GEMMs also run at the widths of gemma3-1b,
   chatglm3-6b and mistral-large-123b (``DENSE_GEMM_SHAPES``) and of
   llama4-scout-17b-a16e, arctic-480b (its 128-wide router among them)
   and internvl2-2b (M 319 and its img_proj at M 256,
   ``MOE_VLM_GEMM_SHAPES``) and of rwkv6-7b (``RWKV_GEMM_SHAPES``: its
   4096-square projections, ck / cv, and the decay LoRA's 4096 x 64 and
   64 x 4096, the latter one 64-deep chunk at group 64) and at two K of
   32 x an odd number, group 32 (``TAIL_GEMM_SHAPES``: K 1056 x N 960 and
   K 4128 x N 4096, the kernels' 32-deep tail chunk; a row's bits there
   the same at M 4 and M 128); decode attention
   at their heads (rep 5, 7 and 2 at D 128, ``MOE_VLM_ATTN``) and flash
   prefill at internvl2's one-shot prefill (S 319, 16 heads on 8, D 128)
   and at gemma3-1b's training shapes (B 2, S 2048, 4 heads on 1, D 288;
   a local layer with window 1024 and a global one).
   Flash prefill's backward (training, ``FLASH_BWD_SHAPES``: smollm-360m
   at S 128 and 2048, recurrentgemma-2b at S 4096 with its window,
   whisper-tiny's encoder and its 64 x 1500 cross attention, internvl2's
   S 319, gemma3-1b's two layers at D 288): the backward kernels against
   their plain version, the gradients bit for bit repeatable, the
   forward's lse against the walk's and its output unchanged by writing
   it; SDPA's backward through autograd as the yardstick; each row's work
   plan (grids, split walks, scratch) and the device time of each of its
   kernels (D_i, dK/dV, dQ, the split reduce) in one profiled call.
4. Reference phase: smollm-360m REDUCED, teacher-forced through
   ``decode_step`` on the card (kernels) and on the CPU (plain versions),
   on both KV backends under w4a16kv8, w4a8kv4, w8a8kvfp8 and w8a16kv16;
   recurrentgemma-2b and whisper-tiny REDUCED, one-shot ``prefill`` then
   teacher-forced ``decode_step``, under w4a16kv8 and w16a16kv16;
   chatglm3-6b, mistral-large-123b and gemma3-1b (at head dim 288)
   REDUCED on both backends under w4a16kv8 (``DENSE_REDUCED``);
   llama4-scout and arctic REDUCED on both backends under w4a16kv8 and
   w4a8kv4, the card's routing held to the CPU's up to a near-tie
   (``RoutingHold``, flips counted); internvl2 REDUCED one-shot with the
   other one-shot families, and rwkv6-7b REDUCED likewise under
   w4a16kv8, w4a8kv4 and w16a16kv16; smollm-360m REDUCED with
   sinusoidal positions (``use_rope=False``) through ``decode_step`` on
   both backends and through ``prefill`` (flash prefill); logits must
   agree.  Then ``moe_ffn`` at llama4's full width on the card: the sort
   dispatch ≡ the einsum one, bit for bit, with ample capacity.  Then the
   offline calibration at rwkv6's ck width (``calibration_check``):
   GPTQ-lite no worse than RTN per column, AWQ's chosen alpha no worse
   than alpha 0, and both calibrated weights through
   ``pack_prequantized`` and the A16 kernel against its plain version.
   Then training (``train_reference``): REDUCED smollm-360m,
   llama4-scout (Adafactor), internvl2-2b, recurrentgemma-2b,
   whisper-tiny, rwkv6-7b and gemma3-1b at head dim 288 — loss, every
   gradient leaf of ``loss_fn``
   and one optimizer step on the card (flash kernels forward and
   backward) against the CPU (plain versions), llama4's routing held.
   Then the training phase (``train_phase``): full-size smollm-360m (32
   layers, d_model 960, vocab 49152) through ``train()``, AdamW, 4 steps
   of 8 x 128 tokens, then one step with ``remat=True``, the launch
   counters zeroed just before each and read just after (32 forward and
   32 backward flash launches a step, remat 64 forward, nothing else),
   finite losses, ms/step, tokens/s, peak GiB and a profiled step's
   device busy share; then full-size gemma3-1b (26 layers, d_model 1152,
   head dim 288, vocab 262144, ~1.0 B parameters) the same way, 3 steps
   of 2 x 2048 tokens and a remat step (26 forward and 26 backward flash
   launches a step, remat 52 forward).
5. Serve phase: the full-width smollm-360m (32 layers, d_model 960,
   seeded random weights), 4 slots, max_seq 256, block_size 16,
   prefill_chunk 32, greedy, through ``Engine.generate`` on the dense slab
   and on the paged pool: ``w4a16kv8`` serving 8 requests of 64-token
   prompts and 32 new tokens, then w4a8kv4, w8a8kvfp8 and w8a16kv16
   serving 4 requests of 32-token prompts and 16 new tokens.  Then the
   one-shot-prefill families on the dense slab under w4a16kv8: full-width
   recurrentgemma-2b (26 layers, d_model 2560, vocab 256000), max_seq 512,
   4 requests of 128-token prompts, full-width whisper-tiny (4 + 4
   layers, 1500 frames), max_seq 256, 4 requests of 16-token prompts, and
   internvl2-2b (24 layers, 256 stub image rows before each prompt),
   max_seq 384, 4 requests of 64-token prompts, and full-size rwkv6-7b
   (all 32 layers, d_model 4096, d_ff 14336, vocab 65536; its recurrent
   state in the slab's place), max_seq 256, 4 requests of 129-token
   prompts (two 64-token chunks of its wkv form), 16 new tokens each.
   Around each serve the launch counters are zeroed just
   before and read just after: every GEMM must have gone through the
   kernel its policy routes to and every attention call through its
   kernel (smollm: 7 GEMMs and 1 attention call per layer and step; the
   one-shot families: 8 flash-prefill launches per request, 24 for
   internvl2, none for rwkv6, their packed GEMMs per prefill and per step
   on the A16 kernel — rwkv6 320 of each, 10 a layer — and internvl2's
   decode attention on the slab kernel).  For each
   smollm policy the dense and paged token streams must be identical.
   One request per w4a16kv8 serve is replayed teacher-forced and must
   follow its argmax (rwkv6's with the serve's batch, ``LOCKSTEP_REPLAY``).
   Then the K-tail phase (``tail_phase``): smollm-360m REDUCED with d_ff
   480, whose w2 (K 15 x 32) packs at block_k = group = 32, teacher-forced
   on the card against the CPU on both backends under w4a16kv8, w4a8kv4,
   w8a16kv16 and w8a8kvfp8, then served on the paged pool through
   ``Engine.generate`` under w4a16kv8 and w4a8kv4 (launches counted as
   above), two served streams replayed through the card's engine and a
   CPU engine built from the same weights, logits against each other.
6. Paging serves, full-width smollm-360m w4a16kv8, counters zeroed and
   read around each: a shared-prefix serve (``PREFIX_SERVE``) with prefix
   caching off and on — identical streams, 96 cached tokens on every hit,
   fewer fed tokens and a lower ``peak_live`` with caching on; a contended
   serve (``GROWTH_SERVE``) under reservation, under block growth on a
   pool too small for reservation-level concurrency, and under growth
   with prefix caching — at least one preemption in each growth serve,
   streams identical to reservation's; the dense slab at max_seq 500
   (``DENSE_500_SERVE``: one 500-token tile, sub-tiled), every token the
   teacher-forced argmax up to a near-tie.  Every paged serve ends with no
   live block.
7. The other dense configs (``DENSE_SERVES``), w4a16kv8, on the dense slab
   and the paged pool: gemma3-1b (26 layers, 1100-token prompts past the
   local layers' window of 1024), chatglm3-6b (28 layers) and
   mistral-large-123b at full width and 4 of its 88 layers; launches
   counted as in 5, dense ≡ paged streams, request 0 the teacher-forced
   argmax; gemma3 once more on the slab by ``attn_impl="xla"``, its
   logits, the kernel route's and exact attention's pairwise within
   ``TOL_ROUTES``.  Then the moe configs (``MOE_SERVES``) the same way:
   llama4-scout-17b-a16e at full width and 8 of 48 layers, arctic-480b at
   full width and 1 of 35 (8 packed GEMMs a layer and step: its router is
   one).
8. Examples phase: ``repro_torch.examples`` quickstart,
   mixed_precision_formats and serve_continuous_batching with ``--device
   cuda``: quickstart's kernel rows (``csrc/kvattn.cu`` against the plain
   attention path, ``csrc/mpgemm.cu`` against the dequantize-then-matmul
   path) within the kernel phase's bars, every format's logits finite
   (w4a8kv4 on the A8 GEMM), 16 served requests with prefix-cache hits;
   launches counted around the phase.
9. Roofline phase: after checking ``roofline.analysis.HW``'s HBM capacity
   against the card's, one batched decode step of the smollm-360m paged
   serve, of the llama4-scout-17b-a16e paged serve (8 of 48 layers) and
   of the rwkv6-7b serve (all 32 layers), 4 slots, w4a16kv8, and one
   AdamW step of full-size gemma3-1b at 2 x 2048 tokens
   (``ROOFLINE_SERVES``, ``ROOFLINE_TRAIN``), each counted by
   ``roofline.analyze_step`` on the kernel route and again on the plain
   route on the card (``op_cost.rerouted(kernels.ref.PLAIN)``, llama4's
   routing held to the kernel route's): equal counts, or the phase fails.
   One line a step: counted FLOPs (matmul, other), bytes, model FLOPs,
   compute and memory ms at the card's peaks, the dominant term, the
   measured ms a step (median of 5) and three shares of peak — model
   FLOPs (``mfu``), counted FLOPs, counted bytes; a FLOP share above
   ``SHARE_CAP`` fails, a byte share only where every tensor of the step
   is larger than the L2.  Launches counted around the phase.
10. Multidevice phase (``multidevice_phase``): sequence-parallel prefill
    rank by rank on the one card at full width (``SP_SHAPES``: arctic-480b
    attention on 16 ranks, gemma3-1b's local layer on 4), each rank's
    rows through ``launch.spattn.sp_local`` — the flash kernels at the
    rank's position offset, forward and backward — the counters zeroed
    just before and read just after; the ranks' output and gradients
    against one whole-sequence call, each rank's kernels against their
    plain versions; per rank and whole call: kernel µs, the bound of
    ``kernels.cost`` at that offset, plain µs and SDPA's µs with the
    explicit mask, beside the card's name and power limit.  Then the
    sharded train step (``launch.train.train_sharded``) on a 1 x 1 NCCL
    mesh (world size 1 through ``dist.HashStore``): full-size
    smollm-360m, losses against ``train()``'s, ms a step of both; the
    process group is destroyed after.
11. One JSON line describing each kernel (launches: the training, serve,
    examples, roofline and multidevice phases; rows 5 and 5b with the
    offset shapes), then the result line ``{"ok": true, "device":
    {...}}`` last.

Exits nonzero with no result when there is no CUDA device or when the
port's sources are not beside this script.
"""
import contextlib
import json
import os
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
GEMM_SHAPES = [  # weights, K, N, bk, bn of smollm-360m's packed GEMMs
    ("wq/wo", 960, 960, 64, 96), ("wk/wv", 960, 320, 64, 64),
    ("w1/w3", 960, 2560, 64, 128), ("w2", 2560, 960, 32, 96)]
#: recurrentgemma-2b's packed GEMMs
RG_GEMM_SHAPES = [
    ("wq/wo/wx/wy/wa/wi", 2560, 2560, 32, 128), ("wk/wv", 2560, 256, 32, 128),
    ("w1/w3", 2560, 7680, 32, 96), ("w2", 7680, 2560, 32, 128)]
#: whisper-tiny's packed GEMMs (encoder, decoder and cross attention)
WH_GEMM_SHAPES = [
    ("wq/wk/wv/wo", 384, 384, 128, 128), ("w1", 384, 1536, 128, 96),
    ("w2", 1536, 384, 32, 128)]
#: the packed GEMMs of the three other dense configs (gemma3-1b,
#: chatglm3-6b, mistral-large-123b), as ``models.common.pick_blocks``
#: tiles them
DENSE_GEMM_SHAPES = [
    ("gemma3 wq/wo", 1152, 1152, 128, 128),
    ("gemma3 wk/wv", 1152, 288, 128, 96),
    ("gemma3 w1/w3", 1152, 6912, 128, 128),
    ("gemma3 w2", 6912, 1152, 128, 128),
    ("chatglm3 wq/wo", 4096, 4096, 128, 128),
    ("chatglm3 wk/wv", 4096, 256, 128, 128),
    ("chatglm3 w1/w3", 4096, 13696, 128, 128),
    ("chatglm3 w2", 13696, 4096, 128, 128),
    ("mistral wq/wo", 12288, 12288, 128, 128),
    ("mistral wk/wv", 12288, 1024, 128, 64),
    ("mistral w1/w3", 12288, 28672, 128, 128),
    ("mistral w2", 28672, 12288, 128, 128)]
GEMM_MS = (4, 128)           # n_slots x t_step at decode and at prefill
#: the packed GEMMs of the moe and vlm configs, as ``pick_blocks`` tiles
#: them, with the token counts their serves give them (name, K, N, bk, bn,
#: Ms): llama4-scout-17b-a16e's attention and shared expert and
#: arctic-480b's attention, dense residual and 128-wide router at decode
#: and a 32-token chunk of 4 slots; internvl2-2b's at decode and at the
#: one-shot prefill of 256 image + 63 prompt rows, its img_proj at the 256
#: image rows
MOE_VLM_GEMM_SHAPES = [
    ("llama4 wq/wo", 5120, 5120, 64, 64, GEMM_MS),
    ("llama4 wk/wv", 5120, 1024, 64, 64, GEMM_MS),
    ("llama4 ws1/ws3", 5120, 8192, 64, 128, GEMM_MS),
    ("llama4 ws2", 8192, 5120, 128, 64, GEMM_MS),
    ("arctic wq/wo", 7168, 7168, 64, 64, GEMM_MS),
    ("arctic wk/wv", 7168, 1024, 64, 64, GEMM_MS),
    ("arctic ws1/ws3", 7168, 4864, 64, 128, GEMM_MS),
    ("arctic ws2", 4864, 7168, 128, 64, GEMM_MS),
    ("arctic router", 7168, 128, 64, 128, GEMM_MS),
    ("internvl2 wq/wo", 2048, 2048, 128, 128, (4, 319)),
    ("internvl2 wk/wv", 2048, 1024, 128, 64, (4, 319)),
    ("internvl2 w1/w3", 2048, 8192, 128, 128, (4, 319)),
    ("internvl2 w2", 8192, 2048, 128, 128, (4, 319)),
    ("internvl2 img_proj", 1024, 2048, 64, 128, (256,))]
#: rwkv6-7b's ten packed GEMMs a layer, as ``pick_blocks`` tiles them
#: (group = block_k): the six 4096-square projections (wr, wk, wv, wg, wo,
#: cr), the channel-mix ck / cv, and the decay LoRA — w_A one 64-wide
#: column block, w_B a single 64-deep K block at group 64, the smallest K
#: a served config gives the GEMMs
RWKV_GEMM_SHAPES = [
    ("rwkv6 wr/wk/wv/wg/wo/cr", 4096, 4096, 128, 128),
    ("rwkv6 ck", 4096, 14336, 128, 128),
    ("rwkv6 cv", 14336, 4096, 128, 128),
    ("rwkv6 w_A", 4096, 64, 128, 64),
    ("rwkv6 w_B", 64, 4096, 64, 128)]
#: a K of 32 times an odd number, the Pallas GEMMs' block_k = group = 32,
#: which both kernels read as a 32-deep tail chunk: at smollm-360m's width
#: (K 1056 = 33 x 32) and at 4096 (K 4128 = 129 x 32)
TAIL_GEMM_SHAPES = [("tail K 33x32", 1056, 960, 32, 96),
                    ("tail K 129x32", 4128, 4096, 32, 128)]
#: the REDUCED dense config whose w2 takes the tail: smollm-360m REDUCED
#: with d_ff 480 (15 x 32), so w2's K packs at block_k = group = 32
TAIL_D_FF = 480
TAIL_POLICIES = ("w4a16kv8", "w4a8kv4", "w8a16kv16", "w8a8kvfp8")
#: flash prefill at the one-shot serves' shapes: (name, B, H, Hkv, S, D,
#: causal, window) — recurrentgemma's local attention at the serve prompt
#: and where the window binds, whisper-tiny's encoder (not a tile multiple)
#: and its decoder prompt (the serve's 16-token prompt less its last token);
#: gemma3-1b's local and global layers at the training run's 2 x 2048
#: tokens (head dim 288, 4 heads on 1, window 1024 binding)
FLASH_SHAPES = [
    ("recurrentgemma S127", 1, 10, 1, 127, 256, True, 2048),
    ("recurrentgemma S4096", 1, 10, 1, 4096, 256, True, 2048),
    ("whisper encoder S1500", 1, 6, 6, 1500, 64, False, None),
    ("whisper decoder S15", 1, 6, 6, 15, 64, True, None),
    ("internvl2 S319", 1, 16, 8, 319, 128, True, None),
    ("gemma3-1b local S2048", 2, 4, 1, 2048, 288, True, 1024),
    ("gemma3-1b global S2048", 2, 4, 1, 2048, 288, True, None)]
#: flash prefill's bar against its plain version: two bf16 ulps of the
#: largest output (both round p and the output to bf16 at the same points;
#: f32 sum order flips a rounding now and then)
FLASH_REL_TOL = 2 ** -6
#: flash prefill's backward (training) at the training shapes: (name, B,
#: H, Hkv, Sq, Sk, D, causal, window) — smollm-360m's attention at the
#: training phase's 128 tokens and at 2048, recurrentgemma-2b's local
#: attention where the window binds, whisper-tiny's encoder and its
#: training cross attention (64 decoder tokens against 1500 frames),
#: internvl2-2b's 319-row prefill (16 heads on 8), and gemma3-1b's local
#: and global layers at its training run's 2 x 2048 tokens (D 288)
FLASH_BWD_SHAPES = [
    ("smollm-360m S128", 8, 15, 5, 128, 128, 64, True, None),
    ("smollm-360m S2048", 8, 15, 5, 2048, 2048, 64, True, None),
    ("recurrentgemma-2b S4096", 1, 10, 1, 4096, 4096, 256, True, 2048),
    ("whisper encoder S1500", 1, 6, 6, 1500, 1500, 64, False, None),
    ("whisper cross Sq64 Sk1500", 1, 6, 6, 64, 1500, 64, False, None),
    ("internvl2 S319", 1, 16, 8, 319, 319, 128, True, None),
    ("gemma3-1b local S2048", 2, 4, 1, 2048, 2048, 288, True, 1024),
    ("gemma3-1b global S2048", 2, 4, 1, 2048, 2048, 288, True, None)]
#: the backward kernels' bar against their plain version: the same math
#: and bf16 rounding points of P and dS, f32 sums in other orders (a P or
#: dS may round on the other side of a bf16 tie), per gradient relative to
#: its largest element (tests/test_torch_cuda.py); the forward's lse
#: against the walk's, absolute (f32 m + log l from dots summed in other
#: orders)
FLASH_BWD_REL_TOL = 2e-2
LSE_ABS_TOL = 2e-4
#: the training phase: models at full size through ``train()``, AdamW:
#: (arch, steps, batch, sequence), then one step with ``remat=True`` —
#: smollm-360m, and gemma3-1b (head dim 288) at a sequence where the
#: 1024-token window binds on its 22 local layers
TRAIN_RUNS = [("smollm-360m", 4, 8, 128), ("gemma3-1b", 3, 2, 2048)]
#: REDUCED models held card vs CPU in training: loss, every gradient leaf
#: and one optimizer step of each family (llama4 with Adafactor, its
#: big-model optimizer): (arch, optimizer, head dim override) — gemma3 at
#: its full width's 288
TRAIN_REDUCED = [("smollm-360m", "adamw", None),
                 ("llama4-scout-17b-a16e", "adafactor", None),
                 ("internvl2-2b", "adamw", None),
                 ("recurrentgemma-2b", "adamw", None),
                 ("whisper-tiny", "adamw", None), ("rwkv6-7b", "adamw", None),
                 ("gemma3-1b", "adamw", 288)]
#: training bars card vs CPU: loss relative; each gradient leaf relative to
#: its largest element (plus 1e-6 for leaves whose exact gradient is zero,
#: llama4's top-1 router), 5e-2 for the families whose gradients the JAX
#: parity tests found sensitive to rounding order
#: (tests/test_torch_training_families.py); one optimizer step's update
#: against the CPU's, by norm, over the elements whose gradient the bar
#: resolves (|g| above the gradient bar, so both sides agree on its sign:
#: AdamW's first step is lr · sign(g), and an element whose gradient is
#: rounding noise — all of llama4's top-1 router — steps ±lr on either
#: side)
TRAIN_TOL_LOSS = 1e-3
TRAIN_TOL_GRAD = {"recurrentgemma-2b": 5e-2, "rwkv6-7b": 5e-2}
TRAIN_TOL_GRAD_DEFAULT = 3e-2
TRAIN_TOL_UPDATE = 0.1
#: decode attention's bar against its plain version, on peaked inputs: two
#: bf16 ulps of the largest output (the kernel's eight splits round p
#: against other running maxima than the plain walk's single order)
ATTN_REL_TOL = 2 ** -6
#: the GEMMs' bar against their plain version: two bf16 ulps of the largest
#: output
GEMM_REL_TOL = 2 ** -7
KV_FORMATS = ("kv8", "kv4", "kvfp8", "kv16")
#: attention tiles too large to stage whole in a block's 227 KB of shared
#: memory, walked as sub-tiles: (format, B, Hkv, rep, D, tile, tiles per
#: slot, T, first positions), cut into 64-token sub-tiles.  The
#: max_seq-500 slab tile of smollm-360m (D 64 kv8: 7 x 64 + a ragged 52),
#: two such tiles with a chunk crossing from the first into the second, a
#: 512-token pool block at D 64 kv16, and 256-token tiles at D 128 kv8, 32
#: heads on 8 KV heads; the pool's blocks are the slab's tiles, so dense ≡
#: paged holds
SUB_TILES = [("kv8", 4, 5, 3, 64, 500, 1, 1, [450, 130, 300, 20]),
             ("kv8", 4, 5, 3, 64, 500, 1, 32, [400, 0, 256, 96]),
             ("kv8", 4, 5, 3, 64, 500, 2, 32, [600, 0, 480, 96]),
             ("kv16", 4, 5, 3, 64, 512, 2, 1, [900, 130, 511, 512]),
             ("kv8", 4, 8, 4, 128, 256, 2, 1, [400, 130, 255, 256])]
#: decode attention at gemma3-1b's heads (D 288, 4 query heads on 1 KV
#: head), window 1024 with contexts of 37-1500 (1536-token slots of 16-token
#: blocks): (format, B, Hkv, rep, D, tile, tiles per slot, T, first
#: positions, window).  Every format at T 1 and at T 32 (chunks whose rows
#: straddle the window's lower edge), a global layer, and a kv16 64-token
#: block walked as sub-tiles (48 + 16)
D288_CASES = (
    [(fmt, 4, 1, 4, 288, 16, 96, 1, [1100, 1030, 1499, 37], 1024)
     for fmt in KV_FORMATS] +
    [(fmt, 4, 1, 4, 288, 16, 96, 32, [1010, 0, 1400, 1020], 1024)
     for fmt in KV_FORMATS] +
    [("kv8", 4, 1, 4, 288, 16, 96, 1, [1100, 1030, 1499, 37], None),
     ("kv16", 4, 1, 4, 288, 64, 24, 1, [1100, 1030, 1499, 37], 1024)])
#: decode attention at the moe and vlm serves' heads (D 128, kv8): llama4's
#: 40 query heads on 8 KV heads (rep 5) and arctic's 56 (rep 7) at decode
#: and at a 32-token chunk (160 and 224 rows), internvl2's 16 (rep 2) at
#: decode over its 384-token slots: (format, B, Hkv, rep, D, tile, tiles
#: per slot, T, first positions)
MOE_VLM_ATTN = [("kv8", 4, 8, 5, 128, 16, 16, 1, [79, 70, 64, 95]),
                ("kv8", 4, 8, 5, 128, 16, 16, 32, [32, 0, 0, 32]),
                ("kv8", 4, 8, 7, 128, 16, 16, 1, [79, 70, 64, 95]),
                ("kv8", 4, 8, 7, 128, 16, 16, 32, [32, 0, 0, 32]),
                ("kv8", 4, 8, 2, 128, 16, 24, 1, [78, 70, 63, 79])]
#: (policy, requests, prompt length, new tokens) of the serve phase
SERVES = [("w4a16kv8", 8, 64, 32), ("w4a8kv4", 4, 32, 16),
          ("w8a8kvfp8", 4, 32, 16), ("w8a16kv16", 4, 32, 16)]
#: the one-shot-prefill serves: (arch, max_seq, requests, prompt length,
#: new tokens, packed GEMMs per prefill call, per decode step,
#: flash-prefill launches per prefill, decode-attention kernel launches
#: per step), w4a16kv8 on the dense slab.  recurrentgemma: 18 recurrent
#: blocks x 8 GEMMs (wy, wx, wa, wi, wo, w1, w3, w2) + 8 attention blocks
#: x 7, 8 flash-prefill launches; whisper: prefill 4 encoder layers x 6 +
#: 4 cross K/V pairs + 4 decoder layers x 8 (wq, wk, wv, wo, xwq, xwo, w1,
#: w2), a step the decoder's 32, 4 encoder + 4 decoder flash-prefill
#: launches; both decode attention in plain PyTorch, as the reference in
#: XLA.  internvl2: 24 layers x 7 + img_proj per prefill (256 image rows
#: before the 63-token prompt), 24 x 7 a step, 24 flash-prefill launches
#: and 24 slab-kernel launches a step.  rwkv6-7b: all 32 layers, 10 packed
#: GEMMs each (wr, wk, wv, wg, wo, w_A, w_B, ck, cv, cr) per prefill and
#: per step, no attention; 129-token prompts prefill 128 tokens, two
#: 64-token chunks of its wkv form.
ONE_SHOT_SERVES = [("recurrentgemma-2b", 512, 4, 128, 16, 200, 200, 8, 0),
                   ("whisper-tiny", 256, 4, 16, 16, 64, 32, 8, 0),
                   ("internvl2-2b", 384, 4, 64, 16, 169, 168, 24, 24),
                   ("rwkv6-7b", 256, 4, 129, 16, 320, 320, 0, 0)]
#: the policies each one-shot family is held card vs CPU under (REDUCED)
ONE_SHOT_POLICIES = {"rwkv6-7b": ("w4a16kv8", "w4a8kv4", "w16a16kv16")}
#: one-shot serves replayed with the engine's step shapes (every request
#: prefilled alone and spliced into its slot, then lockstep decode steps
#: of the whole batch) instead of one request alone: rwkv6-7b's decode
#: runs its wkv products as batched cuBLAS matmuls whose f32 rounding
#: changes with the batch count, and through 32 layers of random weights
#: that moves its logits by about the near-tie bar (the serve records the
#: gap as ``replay_alone_vs_batch_rel``)
LOCKSTEP_REPLAY = ("rwkv6-7b",)
#: the paging serves, smollm-360m w4a16kv8 on the paged pool (4 slots,
#: block 16, prefill_chunk 32): requests, shared prefix and distinct tail
#: tokens, new tokens — caching off and on
PREFIX_SERVE = (8, 96, 32, 16)
#: the same, plus the pool's blocks for growth: each request grows from 4
#: to 7 blocks, 4 running want 28 of the 20 (reservation holds 7 a
#: request: 2 at a time); served by reservation on the default pool,
#: growth, and growth with prefix caching
GROWTH_SERVE = (8, 32, 32, 48, 20)
#: the dense slab at max_seq 500 (block_size 16 does not divide it: one
#: 500-token tile): requests, prompt tokens, new tokens, max_seq
DENSE_500_SERVE = (4, 64, 16, 500)
#: the other dense configs' serves, w4a16kv8 on both backends (4 slots,
#: block 16), dense ≡ paged streams: (arch, layers served (None: all),
#: max_seq, requests, prompt tokens, new tokens, prefill_chunk).  gemma3's
#: 1100-token prompts put keys before every local layer's window of 1024;
#: mistral-large-123b at full width and 4 of its 88 layers (its bf16
#: weights, ~246 GB, are drawn on the card before packing)
DENSE_SERVES = [("gemma3-1b", None, 1536, 4, 1100, 16, 128),
                ("chatglm3-6b", None, 256, 4, 64, 16, 32),
                ("mistral-large-123b", 4, 256, 4, 64, 16, 32)]
#: the moe configs' serves, the same pairs: llama4-scout-17b-a16e at full
#: width and 8 of its 48 layers, arctic-480b at full width and 1 of its 35
#: (their bf16 weights, ~39 GB and ~28 GB, are drawn on the card before
#: packing).  Packed GEMMs per layer and step: llama4 7 (wq, wk, wv, wo,
#: the shared expert's three; its 16-wide router stays bf16), arctic 8
#: (the dense residual's three and the 7168 x 128 router)
MOE_SERVES = [("llama4-scout-17b-a16e", 8, 256, 4, 64, 16, 32),
              ("arctic-480b", 1, 256, 4, 64, 16, 32)]
MOE_GEMMS_PER_LAYER = {"llama4-scout-17b-a16e": 7, "arctic-480b": 8}
#: REDUCED moe models held card vs CPU (w4a16kv8 and w4a8kv4, both
#: backends, routing held)
MOE_REDUCED = ("llama4-scout-17b-a16e", "arctic-480b")
#: a routing flip card vs CPU is accepted where the card's router
#: probabilities of its own choice and the CPU's differ by less than the
#: logit bar times this (tests/test_torch_moe.py); the card then takes the
#: CPU's choice, so later steps stay comparable
FLIP_SHARE = 0.2
#: REDUCED models of the dense configs held card vs CPU: (arch, head dim
#: override) — gemma3 at its full width's 288
DENSE_REDUCED = [("chatglm3-6b", None), ("mistral-large-123b", None),
                 ("gemma3-1b", 288)]
#: logits tolerance, relative to max |logit|: A8 policies re-quantize
#: every GEMM input per token, which turns one-ulp differences of sum
#: order into int8 rounding flips (tests/test_torch_model.py)
TOL, TOL_A8 = 2e-2, 1e-1
#: gemma3-1b's two attention routes (kernels; the xla opt-out) against each
#: other and each against exact attention (f64, no bf16 rounding inside
#: attention), teacher-forced through all 26 layers: each route sits up to
#: ~2.3e-2 · max |logit| from exact attention there — bf16 rounding
#: through a deep network, a few bf16 ulps of logits near 3 — so the
#: routes are held at 3e-2, and to exact attention at the same bar
TOL_ROUTES = 3e-2


def check(cond, msg):
    """Raise unless ``cond`` holds (survives ``python -O``)."""
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def time_ms(fn, flush, iters=20):
    """Median device time of ``fn`` over ``iters`` launches, each after a
    1 GiB write that evicts the 50 MB L2 (the main path streams each
    layer's weights and KV once per step, so it finds them cold).  The
    write also keeps the card busy for ~0.4 ms, longer than the host takes
    to record the start event and enqueue ``fn`` (a library call with
    several launches included), so the events time the device work and
    not the host's latency."""
    import torch
    fn()
    ev = []
    for _ in range(iters):
        flush.zero_()
        s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        s.record()
        fn()
        e.record()
        ev.append((s, e))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in ev)


def bound_ms(nbytes, ops, ops_per_s=None):
    """Least time for the work on an H100 (``roofline.analysis.HW``: HBM
    bandwidth, and the bf16 peak unless ``ops_per_s`` says otherwise), and
    what sets it."""
    from repro_torch.roofline import HW
    t_b = nbytes / HW.hbm_bw
    t_o = ops / (ops_per_s or HW.peak_flops)
    return max(t_b, t_o) * 1e3, ("bytes" if t_b >= t_o else "operations")


def gemm_phase(dev, flush):
    """Both GEMM kernels against their plain versions at smollm-360m's,
    recurrentgemma-2b's, whisper-tiny's, the three other dense configs',
    rwkv6-7b's and the moe and vlm configs' packed shapes and at the two
    32-deep K tails (``TAIL_GEMM_SHAPES``), bits 4 and 8, the weights in
    the kernels' fragment order.  At the tails, a row's bits must not
    depend on M: the first 4 rows of the M 128 call are those of a call
    on those 4 rows alone."""
    import torch
    from repro_torch.core.packing import (dequantize_packed, pack_weight,
                                          to_kernel_layout)
    from repro_torch.core.quantize import quantize_act_per_token
    from repro_torch.kernels import cost as KC
    from repro_torch.kernels.mpgemm import mpgemm_a16, mpgemm_int8
    from repro_torch.kernels.ref import mpgemm_int8_ref, mpgemm_ref
    from repro_torch.roofline import HW
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    rows = {"mpgemm_a16": [], "mpgemm_int8": []}
    shapes = [(f"smollm {n}", *shape) for n, *shape in GEMM_SHAPES] + \
        [(f"recurrentgemma {n}", *shape) for n, *shape in RG_GEMM_SHAPES] + \
        [(f"whisper {n}", *shape) for n, *shape in WH_GEMM_SHAPES] + \
        DENSE_GEMM_SHAPES + RWKV_GEMM_SHAPES + TAIL_GEMM_SHAPES
    shapes = [s + (GEMM_MS,) for s in shapes] + MOE_VLM_GEMM_SHAPES
    for name, K, N, bk, bn, Ms in shapes:
        w = torch.randn(K, N, generator=gen, device=dev) / K ** 0.5
        for bits in (4, 8):
            # the kernels take their fragment orders; the plain versions
            # read the JAX package's tile-major bytes
            pw = pack_weight(w, bits=bits, group=bk, block_k=bk, block_n=bn)
            frag = {k: to_kernel_layout(pw, k) for k in ("a16", "a8")}
            wd = dequantize_packed(pw, torch.bfloat16)   # yardstick operand
            for M in Ms:
                x = torch.randn(M, K, generator=gen, device=dev).to(
                    torch.bfloat16)
                xq, xs = quantize_act_per_token(x.float(), bits=8)
                for kern, fn, args, plain, pargs, peak, lib in (
                        ("mpgemm_a16", mpgemm_a16, (x, frag["a16"]),
                         mpgemm_ref, (x, pw), HW.peak_flops,
                         lambda: torch.matmul(x, wd)),
                        ("mpgemm_int8", mpgemm_int8, (xq, xs, frag["a8"]),
                         mpgemm_int8_ref, (xq, xs, pw), HW.int8_ops,
                         None)):
                    y, ref = fn(*args), plain(*pargs)
                    torch.cuda.synchronize()
                    err = (y.float() - ref.float()).abs().max().item()
                    tol = GEMM_REL_TOL * ref.float().abs().max().item()
                    check(err <= tol, f"{kern} {name} bits={bits} M={M}: "
                                      f"|Δ|={err} > {tol}")
                    if K % 64 and M > 4:
                        few = fn(*(a[:4] for a in args[:-1]), args[-1])
                        check(torch.equal(y[:4], few),
                              f"{kern} {name} bits={bits}: rows depend "
                              f"on M")
                    ops, nbytes = KC.OF[kern](*args)
                    b, by = bound_ms(nbytes, ops, peak)
                    rows[kern].append(dict(
                        shape=f"{name} bits={bits} M={M} K={K} N={N} "
                              f"bk={bk} bn={bn}",
                        max_abs_err=err, tol=tol,
                        ms=time_ms(lambda: fn(*args), flush),
                        plain_ms=time_ms(lambda: plain(*pargs), flush),
                        library_ms=None if lib is None
                        else time_ms(lib, flush),
                        bound_ms=b, bound_by=by, bytes=nbytes, ops=ops,
                        ops_per_s=peak))
    return rows


def kv_stores(dev, gen, spec, B, Hkv, D, bs, bps, ctx):
    """A paged pool holding ``ctx[b]`` random tokens for slot b through a
    shuffled block table (sentinel tail) and a dense slab of ``bps * bs``
    tokens per slot holding the same tokens; every other cell of both
    holds finite garbage stored in ``spec``."""
    import dataclasses

    import torch
    from repro_torch.core import kvcache as KV
    from repro_torch.core import paged_kvcache as PKV
    from repro_torch.core.quantize import quantize_kv
    nb = B * bps
    pool = PKV.init_paged(B, nb, bs, Hkv, D, spec, bps, device=dev).layer(0)
    slab = KV.init_cache(B, bps * bs, Hkv, D, spec, device=dev).layer(0)
    for store in (pool, slab):
        for buf, sc in ((store.k, store.k_scale), (store.v, store.v_scale)):
            g = torch.randn(tuple(sc.shape) + (D,), generator=gen, device=dev)
            q, s = quantize_kv(g.to(torch.bfloat16), spec)
            buf.copy_(q)
            sc.copy_(s[..., 0])
    perm = torch.randperm(nb, generator=gen, device=dev).to(torch.int32)
    zero = torch.zeros(1, dtype=torch.int32, device=dev)
    nxt = 0
    for b, n in enumerate(ctx):
        need = PKV.blocks_needed(n, bs)
        pool.block_table[b, :need] = perm[nxt:nxt + need]
        nxt += need
        k = torch.randn(1, n, Hkv, D, generator=gen, device=dev)
        v = torch.randn(1, n, Hkv, D, generator=gen, device=dev)
        k, v = k.to(torch.bfloat16), v.to(torch.bfloat16)
        row = dataclasses.replace(pool, block_table=pool.block_table[b:b + 1])
        PKV.append_paged(row, k, v, zero, spec)
        KV.append_per_slot(KV.KVCache(slab.k[b:b + 1], slab.v[b:b + 1],
                                      slab.k_scale[b:b + 1],
                                      slab.v_scale[b:b + 1]),
                           k, v, zero, spec)
    return pool, slab


def sdpa_backend(fn):
    """Which SDPA implementation PyTorch ran for ``fn``, from the device
    kernels of one profiled call: flash, efficient (cutlass fmha), cudnn,
    or math (no fused kernel: separate matmul and softmax kernels)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    names = " ".join(e.name.lower() for e in prof.events()
                     if e.device_type == DeviceType.CUDA)
    for key, name in (("flash", "flash"), ("fmha", "efficient"),
                      ("cudnn", "cudnn")):
        if key in names:
            return name
    return "math"


def attn_rows(dev, flush, gen, fmt, B, Hkv, rep, D, bs, bps, T, pos, rows,
              chunk_checks, window=None):
    """One attention case: paged and dense-slab kernels against their
    plain versions (``bs``-token tiles: the pool's blocks and the slab's
    ``block_s``), dense ≡ paged bit for bit, each timed beside SDPA (the
    same mask).  With ``chunk_checks`` a chunk's rows must be the bits of
    its tokens fed one at a time and of each slot served alone.  Appends
    to ``rows``."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core import paged_kvcache as PKV
    from repro_torch.core.precision import get_policy
    from repro_torch.core.quantize import dequantize_kv
    from repro_torch.kernels import cost as KC
    from repro_torch.kernels.kvattn import kvattn
    from repro_torch.roofline import HW
    from repro_torch.kernels.paged_kvattn import paged_kvattn
    from repro_torch.kernels.ref import (NO_WINDOW, kvattn_ref,
                                         paged_kvattn_ref)
    spec = get_policy(f"w4a16{fmt}").kv
    S = bps * bs
    ctx = [p + T for p in pos]
    win = NO_WINDOW if window is None else window
    pool, slab = kv_stores(dev, gen, spec, B, Hkv, D, bs, bps, ctx)
    R = T * rep
    # peaked: scores of std 4, so a few keys carry each row and a dropped
    # tile or split moves the output by O(1)
    q = (4 * torch.randn(B, Hkv, R, D, generator=gen, device=dev)).to(
        torch.bfloat16)
    posd = torch.tensor(pos, dtype=torch.int32, device=dev)
    n_live = PKV.blocks_needed(max(ctx), bs)
    pargs = (q, pool.k, pool.k_scale, pool.v, pool.v_scale,
             pool.block_table, posd, win, rep, n_live)
    dargs = (q, slab.k, slab.k_scale, slab.v, slab.v_scale, posd, win, rep)
    # yardstick: SDPA over the slab's live prefix, dequantized bf16
    Sl = n_live * bs
    kd, vd = (dequantize_kv(t[:, :Sl], sc[:, :Sl, :, None], spec)
              .permute(0, 2, 1, 3).contiguous()
              for t, sc in ((slab.k, slab.k_scale), (slab.v, slab.v_scale)))
    qh = q.reshape(B, Hkv, T, rep, D).permute(0, 1, 3, 2, 4) \
        .reshape(B, Hkv * rep, T, D).contiguous()
    qpos = posd.long()[:, None] + torch.arange(T, device=dev)
    kpos = torch.arange(Sl, device=dev)[None, None]
    mask = ((kpos <= qpos[:, :, None]) &
            (kpos > qpos[:, :, None] - win))[:, None]
    sdpa = lambda: F.scaled_dot_product_attention(   # noqa: E731
        qh, kd, vd, attn_mask=mask, enable_gqa=True)
    check(torch.isfinite(sdpa().float()).all().item(), "SDPA not finite")
    shape = (f"{fmt} B={B} Hkv={Hkv} rep={rep} D={D} T={T} R={R} bs={bs} "
             f"n_live={n_live} S={S}" +
             ("" if window is None else f" window={window}"))
    outs = {}
    for kern, fn, args, plain in (
            ("paged_kvattn", paged_kvattn, pargs + (spec,),
             lambda: paged_kvattn_ref(*pargs)),
            ("kvattn", kvattn, dargs + (bs, spec),
             lambda: kvattn_ref(*dargs, bs))):
        out, ref = fn(*args), plain()
        torch.cuda.synchronize()
        check(torch.isfinite(out.float()).all().item(),
              f"{kern} {shape} not finite")
        err = (out.float() - ref.float()).abs().max().item()
        tol = ATTN_REL_TOL * ref.float().abs().max().item()
        check(err <= tol, f"{kern} {shape}: |Δ|={err} > {tol}")
        outs[kern] = out
        # what the data needs: each slot's keys inside some row's window,
        # q and out, positions (+ the table rows); ops: each row's kept keys
        ops, nbytes = KC.OF[kern](*args)
        b, by = bound_ms(nbytes, ops)
        rows[kern].append(dict(
            shape=shape, max_abs_err=err, tol=tol,
            ms=time_ms(lambda: fn(*args), flush),
            plain_ms=time_ms(plain, flush, iters=5),
            library_ms=time_ms(sdpa, flush), library=sdpa_backend(sdpa),
            bound_ms=b, bound_by=by, bytes=nbytes, ops=ops,
            ops_per_s=HW.peak_flops))
    check(torch.equal(outs["kvattn"], outs["paged_kvattn"]),
          f"dense and paged attention differ ({shape})")
    if chunk_checks:
        for t in (0, T // 2, T - 1):
            qt = q[:, :, t * rep:(t + 1) * rep].contiguous()
            one = kvattn(qt, *dargs[1:5], posd + t, win, rep, bs, spec)
            check(torch.equal(one, outs["kvattn"][:, :, t * rep:(t + 1) * rep]),
                  f"kvattn {shape}: token {t} of a chunk differs from its "
                  "T 1 row")
        for b in range(B):
            one = kvattn(q[b:b + 1].contiguous(), slab.k[b:b + 1],
                         slab.k_scale[b:b + 1], slab.v[b:b + 1],
                         slab.v_scale[b:b + 1], posd[b:b + 1], win, rep, bs,
                         spec)
            check(torch.equal(one, outs["kvattn"][b:b + 1]),
                  f"kvattn {shape}: slot {b} alone differs from its batch "
                  "row")


def attn_phase(dev, flush):
    """Paged and dense-slab attention against their plain versions in
    every KV format at the serve shapes (S 256, block 16), then the tiles
    too large to stage whole, walked as sub-tiles (``SUB_TILES``), then
    gemma3-1b's D 288 (``D288_CASES``), then the moe and vlm heads
    (``MOE_VLM_ATTN``)."""
    import torch
    gen = torch.Generator(device=dev)
    gen.manual_seed(2)
    rows = {"paged_kvattn": [], "kvattn": []}
    for fmt in KV_FORMATS:
        for T, pos in ((1, [95, 36, 70, 0]), (32, [32, 0, 64, 96])):
            attn_rows(dev, flush, gen, fmt, 4, 5, 3, 64, 16, 16, T, pos,
                      rows, T > 1)
    for fmt, B, Hkv, rep, D, bs, bps, T, pos in SUB_TILES:
        attn_rows(dev, flush, gen, fmt, B, Hkv, rep, D, bs, bps, T, pos,
                  rows, T > 1)
    for fmt, B, Hkv, rep, D, bs, bps, T, pos, window in D288_CASES:
        attn_rows(dev, flush, gen, fmt, B, Hkv, rep, D, bs, bps, T, pos,
                  rows, T > 1, window)
    for fmt, B, Hkv, rep, D, bs, bps, T, pos in MOE_VLM_ATTN:
        attn_rows(dev, flush, gen, fmt, B, Hkv, rep, D, bs, bps, T, pos,
                  rows, T > 1)
    return rows


def flash_inputs(gen, B, H, Hkv, S, D, dev, Sk=None):
    """q, k, v whose scores single out a few keys per row: q ~ 4 N(0, 1)
    gives scaled scores of std 4, so one key or a mask edge moves the
    output by O(1).  q and k also carry opposite constant offsets that
    lower every real score by 20, under the 0 that an all-zero padding
    key past S would score: an unmasked padding key would swamp the
    row.  v ~ N(0, 1) / 4 keeps outputs within ~1, so the bar (two bf16
    ulps of the largest output) stays under 3e-2."""
    import torch
    c = (20 / D ** 0.5) ** 0.5
    q, k, v = (torch.randn(B, h, n, D, generator=gen, device=dev)
               for h, n in ((H, S), (Hkv, Sk or S), (Hkv, Sk or S)))
    return [t.to(torch.bfloat16) for t in (4 * q - c, k + c, v / 4)]


def flash_phase(dev, flush):
    """The flash-prefill kernel against its plain version (the same tile
    walk in PyTorch ops) at the one-shot serves' shapes; SDPA with the
    same mask as the library yardstick."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import cost as KC
    from repro_torch.kernels.flashprefill import flash_prefill, pick_tile, \
        tiles
    from repro_torch.roofline import HW
    from repro_torch.kernels.ref import NO_WINDOW, flash_prefill_walk
    gen = torch.Generator(device=dev)
    gen.manual_seed(4)
    rows = []
    for name, B, H, Hkv, S, D, causal, window in FLASH_SHAPES:
        q, k, v = flash_inputs(gen, B, H, Hkv, S, D, dev)
        win = NO_WINDOW if window is None else window
        kw = dict(causal=causal, window=window)
        tile = pick_tile(B, H, Hkv, S, D)
        plain = lambda: flash_prefill_walk(   # noqa: E731
            q, k, v, causal, win, S, *tile)
        out, ref = flash_prefill(q, k, v, **kw), plain()
        torch.cuda.synchronize()
        check(torch.isfinite(out.float()).all().item(),
              f"flash_prefill {name} not finite")
        err = (out.float() - ref.float()).abs().max().item()
        tol = FLASH_REL_TOL * ref.float().abs().max().item()
        check(err <= tol, f"flash_prefill {name}: |Δ|={err} > {tol}")
        pos = torch.arange(S, device=dev)
        mask = None
        if causal or window is not None:
            mask = pos[None] > pos[:, None] - win
            if causal:
                mask &= pos[None] <= pos[:, None]
        sdpa = lambda: F.scaled_dot_product_attention(   # noqa: E731
            q, k, v, attn_mask=mask, enable_gqa=Hkv != H)
        lib = sdpa()
        check(torch.isfinite(lib.float()).all().item(), "SDPA not finite")
        ops, nbytes = KC.of_flash_prefill(q, k, v, **kw)
        b, by = bound_ms(nbytes, ops)
        rows.append(dict(
            shape=f"{name} B={B} H={H} Hkv={Hkv} D={D} causal={causal} "
                  f"window={window} tile={tile[0]}x{tile[1]}",
            max_abs_err=err, tol=tol,
            sdpa_max_abs_err=(lib.float() - ref.float()).abs().max().item(),
            ms=time_ms(lambda: flash_prefill(q, k, v, **kw), flush),
            plain_ms=time_ms(plain, flush, iters=5),
            library_ms=time_ms(sdpa, flush),
            bound_ms=b, bound_by=by, bytes=nbytes, ops=ops,
            ops_per_s=HW.peak_flops,
            # every tile the wrapper can choose: the evidence for its rule
            tile_sweep_ms={f"{bq}x{bk}": time_ms(
                lambda: flash_prefill(q, k, v, tile=(bq, bk), **kw),
                flush) for bq, bk in tiles(D)}))
    return {"flash_prefill": rows}


def attn_mask(S, causal, window, dev):
    """SDPA's boolean mask of flash prefill's causal / window mask (None:
    every key)."""
    import torch
    if not causal and window is None:
        return None
    pos = torch.arange(S, device=dev)
    mask = pos[None] > pos[:, None] - (S if window is None else window)
    if causal:
        mask &= pos[None] <= pos[:, None]
    return mask


#: the backward's kernels (``csrc/flash_prefill_bwd.cu``), by the name
#: the profiler reports: ``::<name>_kernel<``
BWD_KERNELS = ("delta", "dkdv", "dq", "split_sum")


def bwd_kernel_us(call, calls=3):
    """Device µs of each backward kernel (``BWD_KERNELS``) a ``call``:
    each kernel's mean over ``calls`` profiled calls (after a warm one)
    times its launches a call — a profile can drop the first event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    call()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            call()
        torch.cuda.synchronize()
    us = {name: [] for name in BWD_KERNELS}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            for name in BWD_KERNELS:
                if f"::{name}_kernel<" in e.name:
                    us[name].append(e.time_range.elapsed_us())
    return {name: sum(t) / len(t) * round(len(t) / calls) if t else 0.0
            for name, t in us.items()}


def bwd_plan_summary(B, H, Hkv, Sq, Sk, D, causal, window, dev):
    """The backward's work plan at a shape on this card: grids, split
    slots, scratch MB and the resident blocks the plan aimed at."""
    from repro_torch.kernels import flashprefill as fp
    from repro_torch.kernels.ref import NO_WINDOW
    plan, _ = fp._device_plan(dev, B, H, Hkv, Sq, Sk, D, causal,
                              NO_WINDOW if window is None else window, Sk)
    kv_b, q_b = plan.scratch_bytes(B, Hkv, D)
    return dict(resident=fp._card(dev.index, D)[1],
                dkdv_grid=[len(plan.kv_items), Hkv, B],
                dkdv_split_tiles=int((plan.kv_tiles[:, 0] > 1).sum()),
                dkdv_slots=plan.kv_slots,
                dq_grid=[len(plan.q_items), Hkv, B],
                dq_split_tiles=int((plan.q_tiles[:, 0] > 1).sum()),
                dq_slots=plan.q_slots, dq_first=plan.dq_first,
                scratch_mb=(kv_b + q_b) / 2 ** 20)


def flash_bwd_phase(dev, flush):
    """The flash-prefill backward kernels against their plain version
    (``ref.flash_prefill_bwd_ref``) and the forward's lse against the
    walk's, at ``FLASH_BWD_SHAPES``; the gradients must repeat bit for bit
    and the output with the lse written must be the output without it.
    Yardstick: SDPA's backward through autograd (same mask).  Each row
    also carries the work plan (``bwd_plan_summary``) and the device µs
    of each kernel of one profiled call (``bwd_kernel_us``)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import cost as KC
    from repro_torch.kernels.flashprefill import (flash_prefill,
                                                  flash_prefill_bwd,
                                                  pick_tile)
    from repro_torch.roofline import HW
    from repro_torch.kernels.ref import (NO_WINDOW, flash_prefill_bwd_ref,
                                         flash_prefill_walk)
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    rows = []
    for name, B, H, Hkv, Sq, Sk, D, causal, window in FLASH_BWD_SHAPES:
        q, k, v = flash_inputs(gen, B, H, Hkv, Sq, D, dev, Sk=Sk)
        do = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
        win = NO_WINDOW if window is None else window
        kw = dict(causal=causal, window=window)
        out, lse = flash_prefill(q, k, v, return_lse=True, **kw)
        check(torch.equal(out, flash_prefill(q, k, v, **kw)),
              f"flash_prefill {name}: writing the lse changed the output")
        _, ref_lse = flash_prefill_walk(q, k, v, causal, win, Sk,
                                        *pick_tile(B, H, Hkv, Sq, D),
                                        return_lse=True)
        lse_err = (lse - ref_lse).abs().max().item()
        check(lse_err <= LSE_ABS_TOL, f"lse {name}: |Δ|={lse_err}")
        grads = flash_prefill_bwd(q, k, v, out, lse, do, **kw)
        again = flash_prefill_bwd(q, k, v, out, lse, do, **kw)

        def plain():
            return flash_prefill_bwd_ref(q, k, v, out, lse, do, causal, win,
                                         Sk)
        ref = plain()
        torch.cuda.synchronize()
        errs = {}
        for gname, g, g2, r in zip(("dq", "dk", "dv"), grads, again, ref):
            check(torch.isfinite(g.float()).all().item(),
                  f"flash_prefill_bwd {name} {gname} not finite")
            check(torch.equal(g, g2),
                  f"flash_prefill_bwd {name} {gname} not repeatable")
            err = (g.float() - r.float()).abs().max().item()
            top = r.float().abs().max().item()
            check(err <= FLASH_BWD_REL_TOL * top,
                  f"flash_prefill_bwd {name} {gname}: |Δ|={err} > "
                  f"{FLASH_BWD_REL_TOL} x {top}")
            errs[gname] = (err, err / top)
        leaves = [t.detach().clone().requires_grad_(True) for t in (q, k, v)]
        lib_out = F.scaled_dot_product_attention(
            *leaves, attn_mask=attn_mask(Sq, causal, window, dev),
            enable_gqa=Hkv != H)

        def library():
            return torch.autograd.grad(lib_out, leaves, do,
                                       retain_graph=True)
        ops, nbytes = KC.of_flash_prefill_bwd(q, k, v, out, lse, do, **kw)
        b, by = bound_ms(nbytes, ops)

        def kernel():
            return flash_prefill_bwd(q, k, v, out, lse, do, **kw)
        rows.append(dict(
            shape=f"{name} B={B} H={H} Hkv={Hkv} D={D} causal={causal} "
                  f"window={window}",
            max_abs_err=max(e for e, _ in errs.values()),
            rel_err={k: r for k, (_, r) in errs.items()},
            lse_max_abs_err=lse_err,
            plan=bwd_plan_summary(B, H, Hkv, Sq, Sk, D, causal, window,
                                  dev),
            kernel_us=bwd_kernel_us(kernel),
            ms=time_ms(kernel, flush),
            plain_ms=time_ms(plain, flush, iters=5),
            library_ms=time_ms(library, flush),
            bound_ms=b, bound_by=by, bytes=nbytes, ops=ops,
            ops_per_s=HW.peak_flops))
    return {"flash_prefill_bwd": rows}


def to_device(params, dev, policy):
    """Parameter dict/list of tensors and PackedWeights → ``dev``, packed
    2-D weights on the card in the fragment order of the GEMM kernel
    ``policy`` routes to, expert stacks in the A16 kernel's (as the
    engine's ``quantize_params`` lays them out there)."""
    import torch
    from repro_torch.core.packing import PackedWeight, to_kernel_layout
    if isinstance(params, dict):
        return {k: to_device(v, dev, policy) for k, v in params.items()}
    if isinstance(params, list):
        return [to_device(v, dev, policy) for v in params]
    if isinstance(params, PackedWeight) and torch.device(dev).type == "cuda":
        return to_kernel_layout(params.to(dev), "a8" if policy.int8_matmul
                                and not params.stacked else "a16")
    return params.to(dev)



def new_cache(model, policy, kind, slots, dev, max_seq=256, block_s=16,
              attn_impl="kernel"):
    """A fresh cache of ``kind`` (dense: ``max_seq`` tokens a slot walked
    in ``block_s`` tiles; paged: ``max_seq`` tokens a slot in 16-token
    blocks, slot b's table row mapping its own blocks in shuffled order)
    and the decode_step keywords the engine passes with it."""
    import torch
    if kind == "dense":
        return model.init_cache(policy, slots, max_seq, dev), \
            lambda p: dict(attn_block_s=block_s, attn_impl=attn_impl)
    bps = max_seq // 16
    cache = model.init_paged_cache(policy, slots, bps * slots, 16, bps, dev)
    perm = torch.randperm(bps * slots, generator=torch.Generator()
                          .manual_seed(slots)).to(torch.int32)
    cache.block_table.copy_(perm.reshape(slots, bps))

    def live(p):
        from repro_torch.core.paged_kvcache import blocks_needed
        return dict(max_live=min(1 << (blocks_needed(p + 1, 16) - 1)
                                 .bit_length(), bps) * 16,
                    attn_impl=attn_impl)
    return cache, live


def teacher_forced(model, params, policy, cache, kw, stream, chunks):
    """Feed ``stream`` (1-D list) through decode_step in ``chunks`` (lists
    of token counts); returns the float logits of every step's last row."""
    import torch
    dev = cache.k.device
    out, p = [], 0
    for n in chunks:
        toks = torch.tensor([stream[p:p + n]], dtype=torch.int64, device=dev)
        logits, _ = model.decode_step(
            params, policy, toks, cache,
            torch.tensor([p], dtype=torch.int32, device=dev), **kw(p))
        out.append(logits[0].float().cpu())
        p += n
    return out


def reference_phase(dev):
    """REDUCED smollm: the kernels on the card against the plain versions
    on the CPU, teacher-forced, same packed weights, both backends."""
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.core.precision import get_policy
    from repro_torch.models.registry import build
    from repro_torch.serving.engine import quantize_params
    cfg = get_reduced("smollm-360m")
    model = build(cfg)
    raw = model.init_params(0, "cpu")
    stream = torch.randint(1, cfg.vocab, (12,),
                           generator=torch.Generator().manual_seed(3)).tolist()
    chunks = [4, 4] + [1] * 4
    worst = {}
    for name, *_ in SERVES:
        pol = get_policy(name)
        params = quantize_params(raw, pol)
        tol = TOL_A8 if pol.int8_matmul else TOL
        for kind in ("dense", "paged"):
            logits = {}
            for d in ("cpu", dev):
                cache, kw = new_cache(model, pol, kind, 1, d)
                logits[str(d)] = teacher_forced(model,
                                                to_device(params, d, pol),
                                                pol, cache, kw, stream,
                                                chunks)
            worst[f"{name}/{kind}"] = compare_logits(
                logits["cpu"], logits[str(dev)], tol, f"{name} {kind}")
    return worst


def tail_phase(dev, totals):
    """smollm-360m REDUCED with d_ff ``TAIL_D_FF`` (15 x 32): w2's K packs
    at block_k = group = 32 and runs through both kernels' 32-deep tail.
    Teacher-forced ``decode_step`` on the card (kernels) against the CPU
    (plain versions), same packed weights, both backends, under
    ``TAIL_POLICIES`` (both GEMMs, bits 4 and 8).  Then, for w4a16kv8 and
    w4a8kv4, an engine on the card and one on the CPU from the same
    weights: w2's codes and scales bit for bit, a paged serve on the card
    through ``Engine.generate`` (the launch counters zeroed just before
    and read just after, every GEMM on the policy's kernel, launches
    added to ``totals``), and two served streams fed teacher-forced
    through each engine's model and weights, the card's logits against
    the CPU's.  Returns the worst relative errors and the serves'
    numbers."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.core.packing import unpack_weight
    from repro_torch.core.precision import get_policy
    from repro_torch.models.registry import build
    from repro_torch.serving import Engine, EngineConfig
    from repro_torch.serving.engine import quantize_params
    cfg = dataclasses.replace(get_reduced("smollm-360m"), d_ff=TAIL_D_FF)
    model = build(cfg)
    raw = model.init_params(0, "cpu")
    stream = torch.randint(1, cfg.vocab, (12,),
                           generator=torch.Generator().manual_seed(5)).tolist()
    worst, serves = {}, []
    for name in TAIL_POLICIES:
        pol = get_policy(name)
        params = quantize_params(raw, pol)
        w2 = params["layers"][0]["w2"]
        check(w2.shape[0] % 64 == 32 and w2.group == 32,
              f"d_ff {TAIL_D_FF}: w2 {w2.shape} at group {w2.group} is not "
              f"a 32-deep K tail")
        tol = TOL_A8 if pol.int8_matmul else TOL
        for kind in ("dense", "paged"):
            logits = {}
            for d in ("cpu", dev):
                cache, kw = new_cache(model, pol, kind, 1, d)
                logits[str(d)] = teacher_forced(
                    model, to_device(params, d, pol), pol, cache, kw, stream,
                    [4, 4] + [1] * 4)
            worst[f"d_ff {TAIL_D_FF} {name}/{kind}"] = compare_logits(
                logits["cpu"], logits[str(dev)], tol,
                f"d_ff {TAIL_D_FF} {name} {kind}")
    prompts = np.random.default_rng(9).integers(1, cfg.vocab,
                                                (4, 24)).tolist()
    for name in ("w4a16kv8", "w4a8kv4"):
        eng = {str(d): Engine(EngineConfig(
            model=cfg, policy=name, n_slots=4, max_seq=64, block_size=16,
            prefill_chunk=16, seed=0, device=d, cache_kind="paged"),
            params=raw) for d in ("cpu", dev)}
        card, cpu = eng[str(dev)], eng["cpu"]
        for lg, lc in zip(card.params["layers"], cpu.params["layers"]):
            check(lg["w2"].layout != "tile" and torch.equal(
                unpack_weight(lg["w2"]).cpu(), unpack_weight(lc["w2"])) and
                torch.equal(lg["w2"].scales.cpu(), lc["w2"].scales),
                f"d_ff {TAIL_D_FF} {name}: the card's w2 is not the CPU's")
        label = f"d_ff {TAIL_D_FF} {name}/paged"
        res, outs = run_serve(card, label, prompts, 8, prompts[0], totals)
        tol = TOL_A8 if card.policy.int8_matmul else TOL
        for prompt, o in list(zip(prompts, outs))[:2]:
            got, ref = (route_logits(e, "paged", prompt, o.output_token_ids,
                                     max_seq=64, chunk=16)
                        for e in (card, cpu))
            res["max_rel_err"] = max(res.get("max_rel_err", 0.0),
                                     compare_logits(ref, got, tol, label))
        serves.append(res)
        del eng, card, cpu
        torch.cuda.empty_cache()
    return worst, serves


def dense_reference(dev):
    """REDUCED chatglm3, mistral and gemma3 at head dim 288 under
    w4a16kv8: the kernels on the card against the plain versions on the
    CPU, teacher-forced over 44 tokens (past gemma3 REDUCED's window of
    32), same packed weights, both backends."""
    import dataclasses

    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.core.precision import get_policy
    from repro_torch.models.registry import build
    from repro_torch.serving.engine import quantize_params
    pol = get_policy("w4a16kv8")
    worst = {}
    for arch, hd in DENSE_REDUCED:
        cfg = get_reduced(arch)
        if hd is not None:
            cfg = dataclasses.replace(cfg, head_dim=hd)
        model = build(cfg)
        params = quantize_params(model.init_params(0, "cpu"), pol)
        stream = torch.randint(1, cfg.vocab, (44,), generator=torch
                               .Generator().manual_seed(7)).tolist()
        for kind in ("dense", "paged"):
            logits = {}
            for d in ("cpu", dev):
                cache, kw = new_cache(model, pol, kind, 1, d)
                logits[str(d)] = teacher_forced(
                    model, to_device(params, d, pol), pol, cache, kw, stream,
                    [16, 16, 8, 1, 1, 1, 1])
            worst[f"{cfg.name} hd{cfg.hd}/{kind}"] = compare_logits(
                logits["cpu"], logits[str(dev)], TOL, f"{arch} {kind}")
    return worst


class RoutingHold:
    """Within the block, ``models.moe.top_k`` records each call's choices
    (``record``) or, replaying them, holds each call to the recorded one
    up to a near-tie: where the choices differ, this run's router
    probabilities of its own choice and the recorded one must be within
    ``eps``; the recorded choice is then taken, and counted in ``flips``."""

    def __init__(self):
        self.calls, self.flips, self.replay, self.eps = [], [], False, 0.0

    @contextlib.contextmanager
    def run(self, replay, eps=0.0):
        from repro_torch.models import moe as MOE
        from repro_torch.roofline.op_cost import uncounted
        orig = MOE.top_k
        self.replay, self.eps = replay, eps
        todo = list(self.calls) if replay else []

        def top_k(probs, k):
            vals, idx = orig(probs, k)
            with uncounted():        # the hold's ops are not the model's
                return hold(probs, vals, idx)

        def hold(probs, vals, idx):
            if not self.replay:
                self.calls.append(idx.cpu())
                return vals, idx
            want = todo.pop(0).to(idx.device)
            diff = (want != idx).any(-1)
            if not diff.any().item():
                return vals, idx
            gap = (probs.gather(-1, idx) - probs.gather(-1, want)) \
                .max(-1).values[diff].max().item()
            check(gap < self.eps, f"routing differs beyond a near-tie "
                                  f"(gap {gap} >= {self.eps})")
            self.flips.append(gap)
            return probs.gather(-1, want), want

        MOE.top_k = top_k
        try:
            yield
        finally:
            MOE.top_k = orig
        check(not todo, "the replay made fewer router calls")


def moe_reference(dev):
    """REDUCED llama4-scout and arctic under w4a16kv8 and w4a8kv4: the
    kernels on the card against the plain versions on the CPU,
    teacher-forced over 44 tokens, same packed weights, both backends;
    the card's routing held to the CPU's up to a near-tie (flips
    counted); every routed expert on the card through the A16 GEMM."""
    import torch
    from repro_torch import trace
    from repro_torch.configs import get_reduced
    from repro_torch.core.precision import get_policy
    from repro_torch.models.registry import build
    from repro_torch.serving.engine import quantize_params
    worst, flips = {}, {}
    for arch in MOE_REDUCED:
        cfg = get_reduced(arch)
        model = build(cfg)
        raw = model.init_params(0, "cpu")
        stream = torch.randint(1, cfg.vocab, (44,), generator=torch
                               .Generator().manual_seed(8)).tolist()
        for name in ("w4a16kv8", "w4a8kv4"):
            pol = get_policy(name)
            params = quantize_params(raw, pol)
            tol = TOL_A8 if pol.int8_matmul else TOL
            for kind in ("dense", "paged"):
                hold, logits = RoutingHold(), {}
                for i, d in enumerate(("cpu", dev)):
                    cache, kw = new_cache(model, pol, kind, 1, d)
                    c0 = trace.moe_experts_packed, trace.moe_experts_plain
                    with hold.run(replay=i > 0, eps=FLIP_SHARE * tol):
                        logits[str(d)] = teacher_forced(
                            model, to_device(params, d, pol), pol, cache, kw,
                            stream, [16, 16, 8, 1, 1, 1, 1])
                packed = trace.moe_experts_packed - c0[0]
                check(packed > 0 and trace.moe_experts_plain == c0[1],
                      f"{arch} {name} {kind}: {packed} routed experts on "
                      f"the card through the A16 GEMM, "
                      f"{trace.moe_experts_plain - c0[1]} plain")
                key = f"{arch}/{name}/{kind}"
                worst[key] = compare_logits(logits["cpu"], logits[str(dev)],
                                            tol, f"{arch} {name} {kind}")
                flips[key] = len(hold.flips)
    return worst, flips


def one_shot_teacher_forced(model, params, policy, stream, P, extra,
                            max_seq, dev, **kw):
    """Prefill ``stream[:P]`` into a fresh B=1 cache, then feed the rest
    one token at a time through decode_step (keywords ``kw``); returns
    the float logits of the prefill and of every step."""
    import torch
    cache = model.init_cache(policy, 1, max_seq, dev)
    logits, cache = model.prefill(
        params, policy, torch.tensor([stream[:P]], device=dev), cache,
        **extra)
    out = [logits[0].float().cpu()]
    for p in range(P, len(stream)):
        logits, cache = model.decode_step(
            params, policy, torch.tensor([[stream[p]]], device=dev), cache,
            torch.tensor([p], dtype=torch.int32, device=dev), **kw)
        out.append(logits[0].float().cpu())
    return out


def lockstep_teacher_forced(eng, prompts, outs):
    """Replay a one-shot serve of equal-length prompts with the engine's
    step shapes: each prompt minus its last token prefilled alone and
    spliced into its slot, then lockstep decode steps of the whole batch
    fed the served tokens.  Returns each request's float logits before
    each of its served tokens."""
    import torch
    from repro_torch.serving.engine import _slot_insert
    model, pol, dev = eng.model, eng.policy, eng.device
    n = len(prompts)
    cache = model.init_cache(pol, n, eng.max_seq, dev)
    for b, p in enumerate(prompts):
        c1 = model.init_cache(pol, 1, eng.max_seq, dev)
        _, c1 = model.prefill(eng.params, pol,
                              torch.tensor([p[:-1]], device=dev), c1,
                              **eng._extra)
        _slot_insert(cache, c1, b)
    toks = [p[-1] for p in prompts]
    out = [[] for _ in prompts]
    for i in range(len(outs[0].output_token_ids)):
        logits, cache = model.decode_step(
            eng.params, pol, torch.tensor(toks, device=dev)[:, None], cache,
            torch.full((n,), len(prompts[0]) - 1 + i, dtype=torch.int32,
                       device=dev), attn_block_s=eng.attn_block_s)
        for b in range(n):
            out[b].append(logits[b].float().cpu())
        toks = [o.output_token_ids[i] for o in outs]
    return out


def compare_logits(ref, got, tol, what):
    """Card logits within ``tol`` · max |logit| of the CPU's, top-1 equal
    where the CPU's top-2 margin is clear; returns the worst relative
    error."""
    import torch
    rel_max = 0.0
    for lc, lg in zip(ref, got):
        check(torch.isfinite(lg).all().item(),
              f"reference logits not finite ({what})")
        scale = lc.abs().max().item()
        rel = (lg - lc).abs().max().item() / scale
        rel_max = max(rel_max, rel)
        check(rel <= tol, f"{what}: rel err {rel} > {tol} (logits against "
                          "their reference)")
        top2 = lc.topk(2).values
        if (top2[0] - top2[1]).item() > tol * scale:
            check(lg.argmax().item() == lc.argmax().item(),
                  f"top-1 differs ({what})")
    return rel_max


def one_shot_reference(dev):
    """REDUCED recurrentgemma, whisper and internvl2: one-shot prefill
    (the flash-prefill kernel) then teacher-forced decode steps, the card
    against the CPU's plain versions, same packed weights and frames or
    image embeddings."""
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.core.precision import get_policy
    from repro_torch.models.registry import build
    from repro_torch.serving.engine import quantize_params
    worst = {}
    for arch, *_ in ONE_SHOT_SERVES:
        cfg = get_reduced(arch)
        model = build(cfg)
        raw = model.init_params(0, "cpu")
        extra = model.extra_inputs(5, 1, "cpu")
        stream = torch.randint(1, cfg.vocab, (12,), generator=torch.Generator()
                               .manual_seed(6)).tolist()
        for name in ONE_SHOT_POLICIES.get(arch, ("w4a16kv8", "w16a16kv16")):
            pol = get_policy(name)
            params = quantize_params(raw, pol)
            logits = {str(d): one_shot_teacher_forced(
                model, to_device(params, d, pol), pol, stream, 8,
                {k: v.to(d) for k, v in extra.items()}, 32, d)
                for d in ("cpu", dev)}
            worst[f"{arch}/{name}"] = compare_logits(
                logits["cpu"], logits[str(dev)],
                TOL_A8 if pol.int8_matmul else TOL, f"{arch} {name}")
    return worst


def sinusoidal_reference(dev):
    """smollm-360m REDUCED with ``use_rope=False`` (sinusoidal positions)
    under w4a16kv8, the card against the CPU: teacher-forced through
    ``decode_step`` on both backends (decode attention), and a one-shot
    ``prefill`` (flash prefill) then decode steps on the slab."""
    import dataclasses

    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.core.precision import get_policy
    from repro_torch.models.registry import build
    from repro_torch.serving.engine import quantize_params
    cfg = dataclasses.replace(get_reduced("smollm-360m"), use_rope=False)
    model = build(cfg)
    pol = get_policy("w4a16kv8")
    params = quantize_params(model.init_params(0, "cpu"), pol)
    stream = torch.randint(1, cfg.vocab, (12,), generator=torch.Generator()
                           .manual_seed(4)).tolist()
    worst = {}
    for kind in ("dense", "paged"):
        logits = {}
        for d in ("cpu", dev):
            cache, kw = new_cache(model, pol, kind, 1, d)
            logits[str(d)] = teacher_forced(
                model, to_device(params, d, pol), pol, cache, kw, stream,
                [4, 4] + [1] * 4)
        worst[f"sinusoidal/{kind}"] = compare_logits(
            logits["cpu"], logits[str(dev)], TOL, f"sinusoidal {kind}")
    logits = {str(d): one_shot_teacher_forced(
        model, to_device(params, d, pol), pol, stream, 8, {}, 32, d,
        attn_block_s=16) for d in ("cpu", dev)}
    worst["sinusoidal/prefill"] = compare_logits(
        logits["cpu"], logits[str(dev)], TOL, "sinusoidal prefill")
    return worst


def calibration_check(dev):
    """The offline calibration at rwkv6-7b's ck width (4096 x 14336, bits
    4, group 128) on seeded activations (T 256, a few salient channels),
    on the card: GPTQ-lite's per-column error at most RTN's, AWQ's loss at
    its alpha at most its loss at alpha 0 (RTN), both from the functions'
    own sums; then each calibrated weight through ``pack_prequantized`` →
    ``to_kernel_layout`` → ``mpgemm_a16`` at M 4 and 128 against the plain
    version (AWQ's with x / s, the scale folded into the activations)."""
    import torch
    from repro_torch.core import calibration as CAL
    from repro_torch.core import quantize as Q
    from repro_torch.core.packing import pack_prequantized, to_kernel_layout
    from repro_torch.kernels.mpgemm import mpgemm_a16
    from repro_torch.kernels.ref import mpgemm_ref
    K, N, T, group = 4096, 14336, 256, 128
    gen = torch.Generator(device=dev)
    gen.manual_seed(11)
    w = torch.randn(K, N, generator=gen, device=dev) / K ** 0.5
    boost = torch.ones(K, device=dev)
    boost[::37] += 30.0
    x = torch.randn(T, K, generator=gen, device=dev) * boost
    t0 = time.perf_counter()
    q, s = CAL.gptq_lite_quantize(w, x, bits=4, group=group)
    q0, s0 = Q.quantize_weight_grouped(w, bits=4, group=group)
    err_g = CAL._col_err(q, s, x, w, group)
    err_r = CAL._col_err(q0, s0, x, w, group)
    check(bool((err_g <= err_r).all()),
          "gptq_lite: a column's error exceeds RTN's")
    alphas, losses, _ = CAL.awq_losses(w, x, bits=4, group=group)
    qa, (sca, sa) = CAL.awq_quantize(w, x, bits=4, group=group)
    best = int(torch.argmin(losses))
    check(losses[best].item() <= losses[0].item(),
          "awq: the chosen alpha's loss exceeds alpha 0's (RTN)")
    torch.cuda.synchronize()
    res = dict(calib_s=time.perf_counter() - t0,
               gptq_mse=err_g.mean().item(), rtn_mse=err_r.mean().item(),
               gptq_columns_kept=int((err_g < err_r).sum()),
               awq_alpha=alphas[best].item(), awq_loss=losses[best].item(),
               awq_loss_alpha0=losses[0].item())
    for label, qq, sc, xs in (("gptq", q, s, None), ("awq", qa, sca, sa)):
        pw = pack_prequantized(qq, sc, bits=4, group=group)
        frag = to_kernel_layout(pw, "a16")
        for M in GEMM_MS:
            xm = x[:M] if xs is None else x[:M] / xs
            xb = xm.to(torch.bfloat16)
            y, ref = mpgemm_a16(xb, frag), mpgemm_ref(xb, pw)
            torch.cuda.synchronize()
            err = (y.float() - ref.float()).abs().max().item()
            tol = 2 ** -7 * ref.float().abs().max().item()
            check(err <= tol,
                  f"calibrated {label} M={M}: |Δ|={err} > {tol}")
            res[f"{label}_M{M}_err"] = err
    del w, x, q, qa
    torch.cuda.empty_cache()
    return res


def train_phase(dev):
    """The training path at full size (``TRAIN_RUNS``): smollm-360m (32
    layers, d_model 960, vocab 49152) and gemma3-1b (26 layers, d_model
    1152, head dim 288, vocab 262144, tied embeddings), seeded random
    weights, through ``train()`` with AdamW, then one step with
    ``remat=True``; the launch counters zeroed just before each run and
    read just after: one forward and one backward flash launch a layer
    and step (remat: two forward), nothing else.  Losses must be finite.
    Then one more step under ``torch.profiler`` for the device's busy
    share."""
    import math
    import torch
    from repro_torch.configs import get_config
    from repro_torch.training.loop import train
    counters = launch_counters()
    res = {}
    for arch, steps, batch, seq in TRAIN_RUNS:
        cfg = get_config(arch)
        for remat, n in ((False, steps), (True, 1)):
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for f in counters.values():
                f.launches = 0
            out = train(cfg, n_steps=n, batch=batch, seq=seq, lr=3e-4,
                        seed=0, log_every=1, remat=remat, device=dev)
            launches = {k: f.launches for k, f in counters.items()}
            L = cfg.n_layers
            want = {k: 0 for k in launches}
            want["flash_prefill"] = L * n * (2 if remat else 1)
            want["flash_prefill_bwd"] = L * n
            label = f"{arch} {'remat' if remat else 'train'}"
            check(launches == want,
                  f"{label}: launches {launches} != {want} ({n} steps)")
            losses = [v for _, v in out["losses"]]
            check(len(losses) == n and all(math.isfinite(v) for v in losses),
                  f"{label}: losses {losses}")
            step_ms = [t * 1e3 for t in out["step_s"]]
            steady = statistics.median(step_ms[1:] or step_ms)
            res[label] = dict(
                arch=cfg.name, steps=n, batch=batch, seq=seq, remat=remat,
                losses=losses, step_ms=step_ms, ms_per_step=steady,
                tokens_per_s=batch * seq / steady * 1e3,
                wall_s=out["wall_s"],
                peak_gib=torch.cuda.max_memory_allocated() / 2 ** 30,
                launches=launches)
            if not remat:
                res[f"{arch} profile"] = train_profile(cfg, out, dev, steps,
                                                       batch, seq)
            del out
    return res


def train_profile(cfg, out, dev, steps, batch, seq):
    """One more AdamW step of a ``train()`` run under ``torch.profiler``:
    device events summed against the host wall clock of the step."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models.registry import build
    from repro_torch.training import data as D
    from repro_torch.training import optimizer as O
    from repro_torch.training.loop import make_train_step
    model = build(cfg)
    step = make_train_step(model, O.for_config(cfg, lr=3e-4,
                                               total_steps=steps))
    toks, tgts = next(D.batches(cfg.vocab, batch, seq, 1, seed=1,
                                device=dev))
    params, state = out["params"], out["opt_state"]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(params, state, toks, tgts)
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    by_name = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            t, n = by_name.get(e.name, (0.0, 0))
            by_name[e.name] = (t + e.time_range.elapsed_us(), n + 1)
    busy = sum(t for t, _ in by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:8]
    bwd = [k for k in by_name
           if any(f"::{n}_kernel<" in k for n in BWD_KERNELS)]
    fwd = [k for k in by_name if "::flash_prefill_kernel<" in k]
    return dict(wall_ms=wall_us / 1e3, device_busy_ms=busy / 1e3,
                device_idle_share=1 - busy / wall_us,
                flash_ms={part: sum(by_name[k][0] for k in ks) / 1e3
                          for part, ks in (("forward", fwd),
                                           ("backward", bwd))},
                top_device=[dict(name=k[:60], ms=t / 1e3, count=n)
                            for k, (t, n) in top])


def train_reference(dev):
    """REDUCED models of every family in training: the loss and every
    gradient leaf of ``loss_fn`` on the card (the flash kernels forward
    and backward) against the CPU (plain versions), same parameters,
    tokens and stub inputs, then one step of the family's optimizer on
    each side, the updates compared; moe routing on the card held to the
    CPU's up to a near-tie (``RoutingHold``)."""
    import dataclasses
    import torch
    from repro_torch.configs import get_reduced
    from repro_torch.core.precision import get_policy
    from repro_torch.models.registry import build
    from repro_torch.training import optimizer as O
    from repro_torch.training.loop import tree_map
    pol = get_policy("w16a16kv16")
    worst = {}
    for base, opt_name, hd in TRAIN_REDUCED:
        cfg = get_reduced(base)
        arch = base
        if hd is not None:
            cfg = dataclasses.replace(cfg, head_dim=hd)
            arch = f"{base} hd{hd}"
        model = build(cfg)
        raw = model.init_params(0, "cpu")
        gen = torch.Generator().manual_seed(9)
        toks, tgts = (torch.randint(0, cfg.vocab, (2, 32), generator=gen)
                      for _ in range(2))
        extra = model.extra_inputs(3, 2, "cpu")
        hold, got = RoutingHold(), {}
        for i, d in enumerate(("cpu", dev)):
            params = tree_map(lambda t: t.detach().to(d, copy=True)
                              .requires_grad_(True), raw)
            with hold.run(replay=i > 0, eps=FLIP_SHARE * TOL):
                loss = model.loss_fn(params, pol, toks.to(d), tgts.to(d),
                                     **{k: v.to(d) for k, v in extra.items()})
                loss.backward()
            grads = tree_map(lambda p: p.grad, params)
            before = tree_map(lambda p: p.detach().clone(), params)
            opt = O.adafactor(lr=1e-2) if opt_name == "adafactor" else \
                O.adamw(lr=1e-2, warmup=1, total_steps=1)
            opt.update(grads, opt.init(params), params)
            got[str(d)] = (loss.item(), O.leaf_groups(tree_map(
                lambda g: None if g is None else g.float().cpu(), grads)),
                O.leaf_groups(params), O.leaf_groups(before))
        (l_cpu, g_cpu, p_cpu, b_cpu), (l_dev, g_dev, p_dev, b_dev) = \
            got["cpu"], got[str(dev)]
        loss_rel = abs(l_dev - l_cpu) / abs(l_cpu)
        check(loss_rel <= TRAIN_TOL_LOSS, f"{arch}: loss {l_dev} vs {l_cpu}")
        tol = TRAIN_TOL_GRAD.get(base, TRAIN_TOL_GRAD_DEFAULT)
        grad_rel = upd_rel = 0.0
        for name, (_, members) in g_cpu.items():
            for j, (a, b) in enumerate(zip(members, g_dev[name][1])):
                if a is None or b is None:
                    check(a is None and b is None, f"{arch} {name}: grad")
                    continue
                top = a.abs().max().item()
                err = (b - a).abs().max().item()
                check(err <= tol * top + 1e-6,
                      f"{arch} {name}[{j}]: grad |Δ|={err} > {tol} x {top}")
                grad_rel = max(grad_rel, err / max(top, 1e-6))
                keep = a.abs() > tol * top + 1e-6   # above the grad bar
                dc = (p_cpu[name][1][j].detach().float() -
                      b_cpu[name][1][j].float())[keep]
                dd = (p_dev[name][1][j].detach().float() -
                      b_dev[name][1][j].float()).cpu()[keep]
                norm = dc.norm().item()
                diff = (dd - dc).norm().item()
                check(diff <= TRAIN_TOL_UPDATE * norm + 1e-6,
                      f"{arch} {name}[{j}]: update |Δ|={diff} vs {norm}")
                upd_rel = max(upd_rel, diff / max(norm, 1e-12))
        worst[arch] = dict(optimizer=opt_name, loss_rel=loss_rel,
                           grad_rel=grad_rel, update_rel=upd_rel,
                           routing_flips=len(hold.flips))
    return worst


def launch_counters():
    """The six kernel wrappers, by name."""
    from repro_torch.kernels.flashprefill import (flash_prefill,
                                                  flash_prefill_bwd)
    from repro_torch.kernels.kvattn import kvattn
    from repro_torch.kernels.mpgemm import mpgemm_a16, mpgemm_int8
    from repro_torch.kernels.paged_kvattn import paged_kvattn
    return {"mpgemm_a16": mpgemm_a16, "mpgemm_int8": mpgemm_int8,
            "paged_kvattn": paged_kvattn, "kvattn": kvattn,
            "flash_prefill": flash_prefill,
            "flash_prefill_bwd": flash_prefill_bwd}


#: kernels only the training path launches (the serves must launch none)
TRAIN_ONLY = ("flash_prefill_bwd",)
#: the flash libraries, whose D 288 functions must spill no register
FLASH_LIBS = ("flash_prefill", "flash_prefill_bwd")


def spill_checked(lib, kern):
    """Whether function ``kern`` of library ``lib`` must spill nothing:
    every backward function at every head dim, and the forward's at
    gemma3's head dim 288."""
    return lib == "flash_prefill_bwd" or (
        lib in FLASH_LIBS and "288" in kern[kern.find("<") + 1:-1].split(", "))


def smollm_engine(dev, **kw):
    """Full-width smollm-360m (seeded random weights) on the card: 4
    slots, max_seq 256, block_size 16, prefill_chunk 32 unless ``kw``
    says otherwise.  Returns the engine and its set-up seconds."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.serving import Engine, EngineConfig
    args = dict(model=get_config("smollm-360m"), n_slots=4, max_seq=256,
                block_size=16, prefill_chunk=32, seed=0, device=dev)
    args.update(kw)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = Engine(EngineConfig(**args))
    torch.cuda.synchronize()
    return eng, time.perf_counter() - t0


def run_serve(eng, label, prompts, new_tokens, warm, totals, gemms=7):
    """Serve ``prompts`` greedily through ``Engine.generate`` after a
    warm-up request ``warm``; the launch counters are zeroed just before
    and read just after.  Checks that every request produced its tokens,
    that each GEMM went through the kernel the policy routes to (``gemms``
    per layer and step; and three A16 launches for each routed expert,
    ``trace.moe_experts_packed``), that every routed expert ran through
    the A16 GEMM (none plain; between one and every expert of each moe
    layer a step) and each attention call through the backend's kernel
    (1 per layer and step), and that a paged engine holds no block at
    the end.  Adds the run's launches to ``totals``; returns the run's
    numbers and the finished outputs."""
    import torch
    from repro_torch import trace
    from repro_torch.serving import SamplingParams, percentile_stats
    eng.generate([warm], SamplingParams(max_new_tokens=2))
    counters = launch_counters()
    for f in counters.values():
        f.launches = 0
    steps0, fed0 = eng.model_steps, eng.fed_tokens
    experts0 = trace.moe_experts_packed, trace.moe_experts_plain
    t0 = time.perf_counter()
    outs = eng.generate(prompts, SamplingParams(max_new_tokens=new_tokens))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counters.items()}
    steps = eng.model_steps - steps0
    for k, n in launches.items():
        totals[k] += n
    cfg, L = eng.model_cfg, eng.model_cfg.n_layers
    n_req = len(prompts)
    check(len(outs) == n_req and all(
        len(o.output_token_ids) == new_tokens for o in outs),
        f"{label}: not every request produced its tokens")
    check(all(0 <= t < cfg.vocab for o in outs for t in o.output_token_ids),
          f"{label}: token outside the vocabulary")
    gemm = "mpgemm_int8" if eng.policy.int8_matmul else "mpgemm_a16"
    attn = "paged_kvattn" if eng.cache_kind == "paged" else "kvattn"
    want = {k: 0 for k in launches}
    want[gemm] = gemms * L * steps
    packed = trace.moe_experts_packed - experts0[0]
    plain = trace.moe_experts_plain - experts0[1]
    n_moe = sum(isinstance(lp, dict) and "we1" in lp
                for lp in eng.params.get("layers", []))
    check(plain == 0 and n_moe * steps <= packed <=
          n_moe * cfg.n_experts * steps,
          f"{label}: routed experts {packed} through the A16 GEMM, {plain} "
          f"plain, over {steps} steps of {n_moe} moe layers")
    want["mpgemm_a16"] += 3 * packed
    if eng.config.attn_impl == "kernel":     # "xla": plain attention
        want[attn] = L * steps
    check(launches == want, f"{label}: launches {launches} != {want} "
                            f"(L={L}, steps={steps})")
    if eng.allocator is not None:
        check(eng.allocator.live_count == 0, f"{label}: KV blocks leaked")
    res = dict(serve=label, policy=eng.policy.name,
               cache_kind=eng.cache_kind, requests=n_req,
               prompt_len=len(prompts[0]), new_tokens=new_tokens,
               model_steps=steps, fed_tokens=eng.fed_tokens - fed0,
               wall_s=wall, tokens_per_s=n_req * new_tokens / wall,
               ms_per_step=wall / steps * 1e3,
               ttft_p50_s=percentile_stats([o.ttft for o in outs])["p50"],
               latency_p50_s=percentile_stats([o.latency for o in outs])["p50"],
               launches=launches, kv_resident_bytes=eng.kv_resident_bytes())
    return res, outs


def route_logits(eng, kind, prompt, out_tokens, max_seq=256, block_s=16,
                 chunk=32, attn_impl="kernel"):
    """Feed ``prompt`` + the served tokens through decode_step on the card
    (``chunk``-token chunks, then one token at a time) by the attention
    route ``attn_impl``; returns the logits of every step from the
    prompt's last on (the step that predicts each served token)."""
    cache, kw = new_cache(eng.model, eng.policy, kind, 1, eng.device,
                          max_seq, block_s, attn_impl)
    n = len(prompt)
    pre = [chunk] * (n // chunk) + ([n % chunk] if n % chunk else [])
    return teacher_forced(eng.model, eng.params, eng.policy, cache, kw,
                          prompt + out_tokens,
                          pre + [1] * (len(out_tokens) - 1))[len(pre) - 1:]


@contextlib.contextmanager
def exact_attention():
    """Within the block, the ``attn_impl="xla"`` route computes decode
    attention exactly: K/V dequantized in f64, scores, softmax and the PV
    product in f64, the output rounded once to q's dtype."""
    from repro_torch.core import quantize as Q
    from repro_torch.models import common as MC
    fused = MC.A.decode_attention

    def exact(q, cache, spec, pos, window=None, impl="fused"):
        import torch
        B, T, H, D = q.shape
        S, Hkv = cache.k.shape[1], cache.k.shape[2]
        kv = [(Q.unpack_int4(t, dim=t.dim() - 1) if spec.packed else t)
              .double() * sc.double()[..., None]
              for t, sc in ((cache.k, cache.k_scale),
                            (cache.v, cache.v_scale))]
        qg = q.reshape(B, T, Hkv, H // Hkv, D).double()
        scores = torch.einsum("bthrd,bshd->bhrts", qg, kv[0]) / D ** 0.5
        qpos = pos.long()[:, None] + torch.arange(T, device=q.device)
        kpos = torch.arange(S, device=q.device)[None, None]
        keep = kpos <= qpos[..., None]
        if window is not None:
            keep &= kpos > qpos[..., None] - window
        scores = scores.masked_fill(~keep[:, None, None], float("-inf"))
        out = torch.einsum("bhrts,bshd->bthrd", scores.softmax(-1), kv[1])
        return out.to(q.dtype).reshape(B, T, H, D)

    MC.A.decode_attention = exact
    try:
        yield
    finally:
        MC.A.decode_attention = fused


def teacher_forced_check(eng, kind, prompt, out_tokens, label, max_seq=256,
                         block_s=16, chunk=32, attn_impl="kernel"):
    """:func:`route_logits`, and each served token must be the argmax of
    its logits up to a near-tie (``TOL``).  Returns the logits."""
    tf = route_logits(eng, kind, prompt, out_tokens, max_seq, block_s, chunk,
                      attn_impl)
    for lg, tok in zip(tf, out_tokens):
        check(lg[tok].item() >= lg.max().item() - TOL * lg.abs().max().item(),
              f"{label}: served token is not the teacher-forced argmax")
    return tf


def serve_one(dev, policy, kind, n_req, prompt_len, new_tokens, totals):
    """Serve full-width smollm-360m once; check the kernels carried every
    GEMM and attention call.  Adds the run's launches to ``totals``."""
    import numpy as np
    import torch
    eng, setup_s = smollm_engine(dev, policy=policy, cache_kind=kind)
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, eng.model_cfg.vocab,
                           (n_req, prompt_len)).tolist()
    res, outs = run_serve(eng, f"{policy}/{kind}", prompts, new_tokens,
                          prompts[0], totals)
    res["setup_s"] = setup_s
    if policy == "w4a16kv8":
        # request 0, teacher-forced on the card: each emitted token must
        # be the argmax of decode_step's logits up to a near-tie
        teacher_forced_check(eng, kind, prompts[0], outs[0].output_token_ids,
                             kind)
    res["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
    streams = [o.output_token_ids for o in outs]
    del eng
    torch.cuda.empty_cache()
    return res, streams


def paged_serve(dev, label, prompts, new_tokens, warm, totals, **kw):
    """One full-width smollm-360m w4a16kv8 serve on the paged pool with
    the engine options ``kw``; returns its numbers (with the per-request
    prefix and preemption counters and the pool's high-water mark) and its
    token streams."""
    import torch
    eng, setup_s = smollm_engine(dev, policy="w4a16kv8", cache_kind="paged",
                                 **kw)
    res, outs = run_serve(eng, label, prompts, new_tokens, warm, totals)
    res.update(setup_s=setup_s, n_blocks=eng.n_blocks,
               peak_live=eng.allocator.peak_live,
               cached_tokens=[o.cached_tokens for o in outs],
               num_preemptions=[o.num_preemptions for o in outs],
               replay_iterations=[o.replay_iterations for o in outs],
               recovery_time_s=[o.recovery_time for o in outs],
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    print("serve:", json.dumps(res))
    del eng
    torch.cuda.empty_cache()
    return res, [o.output_token_ids for o in outs]


def paging_phase(dev, totals):
    """Prefix sharing, block growth with preemption, and the sub-tiled
    dense tile, each served at full width (``PREFIX_SERVE``,
    ``GROWTH_SERVE``, ``DENSE_500_SERVE``) with its streams checked."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    runs = []
    vocab = get_config("smollm-360m").vocab
    # shared prefix: caching off, then on; the warm-up request shares
    # the prefix (not the distinct tail), so every counted request hits
    n_req, shared, distinct, new = PREFIX_SERVE
    rng = np.random.default_rng(11)
    prefix = rng.integers(1, vocab, shared).tolist()
    prompts = [prefix + rng.integers(1, vocab, distinct).tolist()
               for _ in range(n_req + 1)]
    got = {}
    for on in (False, True):
        res, got[on] = paged_serve(dev, f"prefix caching {'on' if on else 'off'}",
                                   prompts[1:], new, prompts[0], totals,
                                   enable_prefix_caching=on)
        runs.append(res)
    off, on = runs[-2], runs[-1]
    check(got[True] == got[False],
          "prefix caching on and off served different streams")
    check(off["cached_tokens"] == [0] * n_req, "caching off reported hits")
    check(on["cached_tokens"] == [shared] * n_req,
          f"prefix hits cached {on['cached_tokens']}, not {shared} each")
    check(on["fed_tokens"] < off["fed_tokens"] and
          on["peak_live"] < off["peak_live"],
          "prefix caching staged no fewer tokens or blocks")

    # contended growth: a pool too small for reservation-level
    # concurrency, against the reservation engine on the default pool
    n_req, shared, distinct, new, n_blocks = GROWTH_SERVE
    rng = np.random.default_rng(12)
    prefix = rng.integers(1, vocab, shared).tolist()
    prompts = [prefix + rng.integers(1, vocab, distinct).tolist()
               for _ in range(n_req + 1)]
    streams = {}
    for label, kw in (("reservation", {}),
                      ("growth", dict(enable_block_growth=True,
                                      n_blocks=n_blocks)),
                      ("growth + prefix caching",
                       dict(enable_block_growth=True, n_blocks=n_blocks,
                            enable_prefix_caching=True))):
        res, streams[label] = paged_serve(dev, label, prompts[1:], new,
                                          prompts[0], totals, **kw)
        runs.append(res)
        if label != "reservation":
            check(sum(res["num_preemptions"]) > 0,
                  f"{label}: no request was preempted: the serve proves "
                  "nothing")
            check(streams[label] == streams["reservation"],
                  f"{label}: streams differ from the reservation engine's")
    check(sum(runs[-1]["cached_tokens"]) > 0,
          "growth + prefix caching: no prefix hit")

    # dense slab at max_seq 500: one 500-token tile, walked as sub-tiles
    n_req, plen, new, max_seq = DENSE_500_SERVE
    eng, setup_s = smollm_engine(dev, policy="w4a16kv8", max_seq=max_seq)
    check(eng.attn_block_s == max_seq, "max_seq 500 is not one tile")
    rng = np.random.default_rng(13)
    prompts = rng.integers(1, vocab, (n_req + 1, plen)).tolist()
    res, outs = run_serve(eng, f"dense max_seq {max_seq}", prompts[1:], new,
                          prompts[0], totals)
    for i in range(n_req):
        teacher_forced_check(eng, "dense", prompts[1 + i],
                             outs[i].output_token_ids, res["serve"],
                             max_seq=max_seq, block_s=max_seq)
    res.update(setup_s=setup_s, attn_block_s=eng.attn_block_s,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    print("serve:", json.dumps(res))
    runs.append(res)
    del eng
    torch.cuda.empty_cache()
    return runs


def serve_one_shot(dev, arch, max_seq, n_req, prompt_len, new_tokens,
                   gemm_prefill, gemm_step, flash_prefill, attn_step,
                   totals):
    """Serve full-width ``arch`` (a one-shot-prefill family) once on the
    dense slab under w4a16kv8; check that every prefill went through the
    flash-prefill kernel, every packed GEMM through the A16 kernel and
    (vlm) every decode attention call through the slab kernel.  Adds the
    run's launches to ``totals``."""
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.serving import (Engine, EngineConfig, SamplingParams,
                                     percentile_stats)
    cfg = get_config(arch)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    eng = Engine(EngineConfig(model=cfg, policy="w4a16kv8", n_slots=4,
                              max_seq=max_seq, seed=0, device=dev))
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    prompts = rng.integers(1, cfg.vocab, (n_req, prompt_len)).tolist()
    sp = SamplingParams(max_new_tokens=new_tokens)
    eng.generate(prompts[:1], SamplingParams(max_new_tokens=2))   # warm-up

    counters = launch_counters()
    for f in counters.values():
        f.launches = 0
    steps0 = eng.model_steps
    t0 = time.perf_counter()
    outs = eng.generate(prompts, sp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counters.items()}
    steps = eng.model_steps - steps0
    for k, n in launches.items():
        totals[k] += n
    check(len(outs) == n_req and all(
        len(o.output_token_ids) == new_tokens for o in outs),
        f"{arch}: not every request produced its tokens")
    check(all(0 <= t < cfg.vocab for o in outs for t in o.output_token_ids),
          f"{arch}: token outside the vocabulary")
    want = {k: 0 for k in launches}
    want["mpgemm_a16"] = gemm_prefill * n_req + gemm_step * steps
    want["flash_prefill"] = flash_prefill * n_req
    want["kvattn"] = attn_step * steps
    check(launches == want, f"{arch}: launches {launches} != {want} "
                            f"({n_req} prefills, {steps} steps)")

    # request 0, teacher-forced on the card: each emitted token must be the
    # argmax of decode_step's logits up to a near-tie (a vlm slot decodes
    # from position n - 1 over the image rows, as in the engine)
    stream = prompts[0] + outs[0].output_token_ids[:-1]
    alone = one_shot_teacher_forced(eng.model, eng.params, eng.policy,
                                    stream, prompt_len - 1, eng._extra,
                                    max_seq, dev,
                                    attn_block_s=eng.attn_block_s)[1:]
    tf, batch_vs_alone = alone, None
    if arch in LOCKSTEP_REPLAY:
        tf = lockstep_teacher_forced(eng, prompts, outs)[0]
        # how far request 0 alone strays from its batch row (recorded)
        batch_vs_alone = max((a - b).abs().max().item() / b.abs().max()
                             .item() for a, b in zip(alone, tf))
    for lg, tok in zip(tf, outs[0].output_token_ids):
        check(lg[tok].item() >= lg.max().item() - TOL *
              lg.abs().max().item(),
              f"{arch}: served token is not the teacher-forced argmax")
    res = dict(arch=arch, policy="w4a16kv8", cache_kind="dense",
               requests=n_req, prompt_len=prompt_len, new_tokens=new_tokens,
               model_steps=steps, wall_s=wall,
               tokens_per_s=n_req * new_tokens / wall,
               ms_per_step=wall / steps * 1e3,
               ttft_p50_s=percentile_stats([o.ttft for o in outs])["p50"],
               latency_p50_s=percentile_stats([o.latency for o in outs])["p50"],
               setup_s=setup_s, launches=launches,
               kv_resident_bytes=eng.kv_resident_bytes(),
               replay_alone_vs_batch_rel=batch_vs_alone,
               peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30)
    del eng
    torch.cuda.empty_cache()
    return res


def dense_config_serves(dev, totals, serves=DENSE_SERVES):
    """The other dense configs (``DENSE_SERVES``), or the moe configs
    (``MOE_SERVES``), served at full width on the dense slab and the
    paged pool (the packed weights built once):
    every GEMM and attention call on its kernel, dense ≡ paged streams,
    request 0's tokens the teacher-forced argmax up to a near-tie.
    gemma3 is also served on the slab by the ``attn_impl="xla"`` opt-out
    (plain attention, no attention kernel launched): at every
    teacher-forced step of its request 0 the opt-out's logits, the kernel
    route's and those of exact attention agree pairwise within
    ``TOL_ROUTES`` · max |logit| (the routes put the KV scales in
    different places, so not bitwise)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.serving import Engine, EngineConfig
    runs = []
    for arch, layers, max_seq, n_req, plen, new, chunk in serves:
        cfg = get_config(arch)
        if layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=layers)
        rng = np.random.default_rng(21)
        prompts = rng.integers(1, cfg.vocab, (n_req, plen)).tolist()
        warm = prompts[0][:64]
        params, streams = None, {}
        routes = [("dense", "kernel"), ("paged", "kernel")]
        if arch == "gemma3-1b":
            routes.append(("dense", "xla"))
        for kind, impl in routes:
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            eng = Engine(EngineConfig(
                model=cfg, policy="w4a16kv8", n_slots=4, max_seq=max_seq,
                block_size=16, prefill_chunk=chunk, cache_kind=kind,
                attn_impl=impl, seed=0, device=dev), params=params)
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
            params = eng.params
            label = f"{arch} L{cfg.n_layers} {kind}/{impl}"
            res, outs = run_serve(eng, label, prompts, new, warm, totals,
                                  MOE_GEMMS_PER_LAYER.get(arch, 7))
            streams[kind, impl] = [o.output_token_ids for o in outs]
            tf = teacher_forced_check(eng, kind, prompts[0],
                                      streams[kind, impl][0], label,
                                      max_seq=max_seq, chunk=chunk,
                                      attn_impl=impl)
            if impl == "xla":        # the same stream by the kernel route
                kw = dict(max_seq=max_seq, chunk=chunk)
                ref = teacher_forced_check(
                    eng, kind, prompts[0], streams[kind, impl][0],
                    f"{label} (kernel route)", **kw)
                with exact_attention():
                    exact = route_logits(eng, kind, prompts[0],
                                         streams[kind, impl][0],
                                         attn_impl="xla", **kw)
                res["rel_err"] = {name: compare_logits(
                    a, b, TOL_ROUTES, f"{arch} {name}") for name, a, b in (
                        ("xla vs kernel route", ref, tf),
                        ("kernel route vs exact", exact, ref),
                        ("xla route vs exact", exact, tf))}
            res.update(arch=arch, n_layers=cfg.n_layers, setup_s=setup_s,
                       peak_mem_gib=torch.cuda.max_memory_allocated() /
                       2 ** 30)
            print("serve:", json.dumps(res))
            runs.append(res)
            del eng
            torch.cuda.empty_cache()
        check(streams["dense", "kernel"] == streams["paged", "kernel"],
              f"{arch}: dense and paged token streams differ on the card")
    return runs


def moe_module_check(dev):
    """``moe_ffn`` at llama4-scout's full width (16 experts of 5120 x 8192,
    bf16, top-1) on the card, capacity ample: the sort dispatch against
    the einsum one, bit for bit (top-1 gates are 1, so both combines
    return the expert's output), for a decode step of 4 slots and a
    32-token chunk of 4; each timed with CUDA events."""
    import dataclasses

    import torch
    from repro_torch.configs import get_config
    from repro_torch.models import moe as MOE
    from repro_torch.models.transformer import _stack_init
    cfg = dataclasses.replace(get_config("llama4-scout-17b-a16e"),
                              capacity_factor=16.0)
    d, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    gen = torch.Generator(device=dev)
    gen.manual_seed(9)
    lp = {"router": (torch.randn(d, E, generator=gen, device=dev) * 0.02)
          .to(torch.bfloat16),
          "we1": _stack_init(gen, E, (d, f)),
          "we3": _stack_init(gen, E, (d, f)),
          "we2": _stack_init(gen, E, (f, d))}
    res = {}
    try:
        for T in (1, 32):
            x = torch.randn(4, T, d, generator=gen, device=dev).to(
                torch.bfloat16)
            out, ms = {}, {}
            for impl in ("einsum", "sort"):
                MOE.set_dispatch_impl(impl)
                out[impl] = MOE.moe_ffn(x, lp, cfg)
                ev = []
                for _ in range(5):
                    a, b = (torch.cuda.Event(enable_timing=True)
                            for _ in range(2))
                    a.record()
                    MOE.moe_ffn(x, lp, cfg)
                    b.record()
                    ev.append((a, b))
                torch.cuda.synchronize()
                ms[impl] = statistics.median(a.elapsed_time(b)
                                             for a, b in ev)
            check(torch.isfinite(out["einsum"].float()).all().item(),
                  "moe_ffn not finite")
            check(torch.equal(out["einsum"], out["sort"]),
                  f"moe_ffn T={T}: sort and einsum dispatch differ")
            res[f"T{T}"] = ms
    finally:
        MOE.set_dispatch_impl("einsum")
    del lp
    torch.cuda.empty_cache()
    return res


def serve_phase(dev):
    """Every serve of ``SERVES`` on both backends (dense and paged streams
    must be identical per policy), then the one-shot serves of
    ``ONE_SHOT_SERVES``.  Returns the runs and the launches of each kernel
    summed over them."""
    totals = {k: 0 for k in launch_counters()}
    runs = []
    for policy, n_req, plen, new in SERVES:
        streams = {}
        for kind in ("dense", "paged"):
            res, streams[kind] = serve_one(dev, policy, kind, n_req, plen,
                                           new, totals)
            runs.append(res)
            print("serve:", json.dumps(res))
        check(streams["dense"] == streams["paged"],
              f"{policy}: dense and paged token streams differ on the card")
    for serve in ONE_SHOT_SERVES:
        res = serve_one_shot(dev, *serve, totals)
        runs.append(res)
        print("serve:", json.dumps(res))
    runs += paging_phase(dev, totals)
    runs += dense_config_serves(dev, totals)
    runs += dense_config_serves(dev, totals, MOE_SERVES)
    for k, n in totals.items():
        check(n > 0 or k in TRAIN_ONLY,
              f"kernel {k} was never launched on the main path")
    return runs, totals


#: the roofline phase's serve steps, one batched decode step of 4 slots
#: each, w4a16kv8, at the widths the serve phase runs: (label, arch,
#: layers or None for all, cache kind, max_seq, prompt length)
ROOFLINE_SERVES = [
    ("smollm-360m paged decode", "smollm-360m", None, "paged", 256, 64),
    ("llama4-scout-17b-a16e L8 paged decode", "llama4-scout-17b-a16e", 8,
     "paged", 256, 64),
    ("rwkv6-7b decode", "rwkv6-7b", None, "dense", 256, 129)]
#: and its training step: (arch, batch, sequence), AdamW
ROOFLINE_TRAIN = ("gemma3-1b", 2, 2048)
#: no card does more than its peak: a share of peak above this fails
SHARE_CAP = 1.05
#: the card's L2: bytes an eager count charges as HBM traffic may hit it
L2_BYTES = 50 * 2 ** 20


def roofline_row(label, cfg, kind, seq, batch, fn, args, moe=False):
    """Count one call of step ``fn(*args)`` on the kernel route and again
    on the plain route (``kernels.ref.PLAIN`` through
    ``roofline.op_cost.rerouted``), both on the card, routing held to the
    kernel route's for a moe model: the counts must be equal.  Then time
    the step (host clock around calls that end in a synchronize, median
    of 5 after a warm call) and put the counted FLOPs, the model FLOPs
    and the counted bytes against the card's peaks: no FLOP share may
    exceed ``SHARE_CAP``, nor the byte share where every tensor of the
    step is larger than the L2."""
    import torch
    from repro_torch.kernels.ref import PLAIN
    from repro_torch.roofline import HW, analyze_step
    from repro_torch.roofline.op_cost import rerouted
    hold = RoutingHold() if moe else None

    def held():
        return hold.run(replay=True, eps=FLIP_SHARE * TOL) if moe \
            else contextlib.nullcontext()

    if moe:
        with hold.run(replay=False):     # the kernel route's routing
            fn(*args)
    kw = dict(arch=cfg.name, shape=label, cfg=cfg, seq=seq, batch=batch,
              kind=kind)
    with held():
        terms = analyze_step(fn, *args, **kw)
    with rerouted(PLAIN), held():
        plain = analyze_step(fn, *args, **kw)
    c, p = terms.cost, plain.cost
    check((c.matmul_flops, c.other_flops, c.bytes, c.kernels) ==
          (p.matmul_flops, p.other_flops, p.bytes, p.kernels),
          f"{label}: the kernel route counts {c} and the plain route {p}")
    fn(*args)
    torch.cuda.synchronize()
    ms = []
    for _ in range(5):
        t0 = time.perf_counter()
        fn(*args)
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3)
    step_ms = statistics.median(ms)
    peak_work = step_ms / 1e3 * HW.peak_flops
    row = dict(step=label, matmul_flops=c.matmul_flops,
               other_flops=c.other_flops, bytes=c.bytes,
               model_flops=terms.model_flops,
               compute_ms=terms.compute_s * 1e3,
               memory_ms=terms.memory_s * 1e3, dominant=terms.dominant,
               ms=step_ms, step_ms=ms,
               mfu=terms.model_flops / peak_work,
               flops_share=terms.hlo_flops / peak_work,
               bw_share=terms.hlo_bytes / (step_ms / 1e3 * HW.hbm_bw),
               smallest_tensor=c.smallest_tensor,
               kernels={k: dict(calls=n, ops=o, bytes=b)
                        for k, (n, o, b) in c.kernels.items()},
               routing_flips=len(hold.flips) if moe else None)
    check(row["mfu"] <= SHARE_CAP and row["flops_share"] <= SHARE_CAP,
          f"{label}: a FLOP share above {SHARE_CAP} of the card's peak "
          f"({row['mfu']:.3f} model, {row['flops_share']:.3f} counted)")
    check(row["bw_share"] <= SHARE_CAP or (c.smallest_tensor or 0) <
          L2_BYTES, f"{label}: {row['bw_share']:.3f} of HBM bandwidth with "
                    "every tensor larger than the L2")
    return row


def roofline_serve_step(dev, label, arch, layers, kind, max_seq, plen):
    """Serve 4 requests of ``plen``-token prompts on full-width ``arch``
    (``layers`` of them when given) and count the engine's first batched
    decode step (``Engine._step_fn`` with every slot at T 1) when it
    comes, before it runs (``roofline_row``; the replays rewrite the same
    KV rows)."""
    import dataclasses

    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.serving import Engine, EngineConfig, SamplingParams
    cfg = get_config(arch)
    if layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    eng = Engine(EngineConfig(model=cfg, policy="w4a16kv8", n_slots=4,
                              max_seq=max_seq, block_size=16,
                              prefill_chunk=32, cache_kind=kind, seed=0,
                              device=dev))
    prompts = np.random.default_rng(21).integers(
        1, cfg.vocab, (4, plen)).tolist()
    step, row = eng._step_fn, {}

    def counted(tokens, pos, valid, *rest):
        args = (tokens, pos, valid) + rest
        if not row and tokens.shape[1] == 1 and (valid == 1).all():
            row.update(roofline_row(label, cfg, "decode", 1, 4, step, args,
                                    moe=cfg.n_experts > 0))
        return step(*args)

    eng._step_fn = counted
    outs = eng.generate(prompts, SamplingParams(max_new_tokens=4))
    check(row and all(len(o.output_token_ids) == 4 for o in outs),
          f"{label}: no batched decode step was counted")
    del eng
    torch.cuda.empty_cache()
    return row


def roofline_train_step(dev):
    """Count and time one AdamW step of full-size ``ROOFLINE_TRAIN``
    (``roofline_row``: forward, backward and update, the flash kernels
    forward and backward)."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.registry import build
    from repro_torch.training import data as D
    from repro_torch.training import optimizer as O
    from repro_torch.training.loop import make_train_step, tree_map
    arch, batch, seq = ROOFLINE_TRAIN
    cfg = get_config(arch)
    model = build(cfg)
    params = tree_map(lambda p: p.requires_grad_(True),
                      model.init_params(0, dev))
    opt = O.for_config(cfg, lr=3e-4, total_steps=10)
    state = opt.init(params)
    toks, tgts = next(D.batches(cfg.vocab, batch, seq, 1, seed=1,
                                device=dev))
    row = roofline_row(f"{arch} train {batch} x {seq}", cfg, "train", seq,
                       batch, make_train_step(model, opt),
                       (params, state, toks, tgts))
    del params, state
    torch.cuda.empty_cache()
    return row


def roofline_phase(dev):
    """The roofline terms of each full-width step the serve and training
    phases run (``ROOFLINE_SERVES``, ``ROOFLINE_TRAIN``) beside its time on
    the card, after checking ``roofline.analysis.HW``'s capacity against
    the card's.  The launch counters are zeroed before and read after."""
    import torch
    from repro_torch.roofline import HW
    total = torch.cuda.get_device_properties(0).total_memory
    check(0.97 * HW.hbm_bytes <= total <= HW.hbm_bytes,
          f"the card holds {total} bytes, HW says {HW.hbm_bytes:.0f}")
    counters = launch_counters()
    for f in counters.values():
        f.launches = 0
    rows = [roofline_serve_step(dev, *serve) for serve in ROOFLINE_SERVES]
    rows.append(roofline_train_step(dev))
    launches = {k: f.launches for k, f in counters.items()}
    for k in ("mpgemm_a16", "paged_kvattn", "flash_prefill",
              "flash_prefill_bwd"):
        check(launches[k] > 0, f"roofline phase: {k} never launched")
    return rows, launches


#: the examples the examples phase runs (``repro_torch.examples``)
EXAMPLES = ("quickstart", "mixed_precision_formats",
            "serve_continuous_batching")
def examples_phase():
    """Run the three examples with ``--device cuda``: quickstart's kernel
    rows within the bars the kernel phase holds the kernels to, every
    format's logits finite, every served request's tokens in the
    vocabulary and the shared prompt served from the prefix cache.  The
    launch counters are zeroed before and read after: the examples reach
    both GEMMs, both decode-attention kernels and flash prefill."""
    import importlib

    import numpy as np
    counters = launch_counters()
    for f in counters.values():
        f.launches = 0
    res = {}
    for name in EXAMPLES:
        t0 = time.perf_counter()
        out = importlib.import_module(f"repro_torch.examples.{name}").main(
            ["--device", "cuda"])
        res[name] = dict(seconds=time.perf_counter() - t0)
        if name == "quickstart":
            check(out["attn_diff"] <= ATTN_REL_TOL * out["attn_scale"] and
                  out["gemm_diff"] <= GEMM_REL_TOL * out["gemm_scale"],
                  f"quickstart: kernel vs plain path {out}")
            res[name].update(out)
        elif name == "mixed_precision_formats":
            check(all(r["finite"] for r in out.values()),
                  "mixed_precision_formats: logits not finite")
            res[name]["formats"] = out
        else:
            toks = [t for o in out["finished"] for t in o.output_token_ids]
            check(len(out["finished"]) == 16 and len(toks) == 16 * 16 and
                  0 <= min(toks) and max(toks) < out["vocab"] and
                  out["cached_tokens"] > 0 and len(out["streamed"]) == 8,
                  "serve_continuous_batching: requests, tokens or prefix "
                  "cache hits missing")
            res[name].update(
                cached_tokens=out["cached_tokens"],
                ttft_p50_s=float(np.median([o.ttft for o in
                                            out["finished"]])))
    launches = {k: f.launches for k, f in counters.items()}
    for k in launches:
        check((launches[k] > 0) == (k not in TRAIN_ONLY),
              f"examples: {k} launched {launches[k]} times")
    return res, launches


#: sequence-parallel prefill rank by rank (``launch.spattn.sp_local``):
#: (name, B, S, H, Hkv, D, window, model-axis ranks) — arctic-480b's
#: attention on the production 16-way model axis (56 / 8 heads divide
#: neither way), gemma3-1b's local layer on 4 ranks (D 288, the window
#: crossing rank boundaries)
SP_SHAPES = [("arctic-480b S4096", 1, 4096, 56, 8, 128, None, 16),
             ("gemma3-1b local S2048", 2, 2048, 4, 1, 288, 1024, 4)]
#: the ranks' concatenated output against one whole-sequence flash call,
#: relative to its largest element: the reference's 0.03 bound
#: (tests/test_sharding.py) tightened by scale; the gradients (dQ per
#: rank, dK / dV summed over the ranks in f32, as a reduce-scatter sums
#: them) against the whole call's at the backward's bar
SP_REL_TOL = 2e-2
#: the sharded train step on a 1 x 1 NCCL mesh (``launch.train.
#: train_sharded``) against ``train()``: (arch, steps, batch, sequence) —
#: the first step is cold, the last two give ms a step; its losses equal
#: or within TRAIN_TOL_LOSS
SHARDED_TRAIN = ("smollm-360m", 3, 8, 128)


def offset_mask(Sq, Sk, off, window, dev):
    """SDPA's boolean mask of causal flash attention with query row t at
    position ``off + t`` (SDPA's ``is_causal`` aligns the diagonal top
    left when Sq != Sk)."""
    import torch
    qpos = off + torch.arange(Sq, device=dev)[:, None]
    kpos = torch.arange(Sk, device=dev)[None]
    mask = kpos <= qpos
    if window is not None:
        mask &= kpos > qpos - window
    return mask


def sp_rows(dev, flush, smi):
    """Sequence-parallel prefill at ``SP_SHAPES``, each rank's rows through
    the kernels at its offset (``sp_local``, forward and backward under
    autograd), against one whole-sequence call and against the plain
    versions on the card; times each rank's and the whole call's forward
    and backward kernels, their plain versions, SDPA with the explicit
    mask (forward; backward through autograd), and the bounds of
    ``kernels.cost`` at each offset.  Returns the per-rank rows, the
    kernel rows (sums over the ranks, for the kernel line) and the launch
    counts of the ``sp_local`` drive."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import cost as KC
    from repro_torch.kernels.flashprefill import (flash_prefill,
                                                  flash_prefill_bwd,
                                                  pick_tile)
    from repro_torch.kernels.ref import (NO_WINDOW, flash_prefill_bwd_ref,
                                         flash_prefill_walk)
    from repro_torch.launch.spattn import sp_local
    from repro_torch.roofline import HW
    counters = launch_counters()
    gen = torch.Generator(device=dev)
    gen.manual_seed(24)
    lines, fwd_rows, bwd_rows = [], [], []
    launches = {k: 0 for k in counters}
    for name, B, S, H, Hkv, D, window, n in SP_SHAPES:
        q, k, v = flash_inputs(gen, B, H, Hkv, S, D, dev)     # head-major
        do = torch.randn(q.shape, generator=gen, device=dev).to(q.dtype)
        win = NO_WINDOW if window is None else window
        Sl = S // n
        kw = dict(causal=True, window=window)
        out, lse = flash_prefill(q, k, v, return_lse=True, **kw)
        whole = flash_prefill_bwd(q, k, v, out, lse, do, **kw)
        # the drive: sp_local rank by rank under autograd, counted
        for f in counters.values():
            f.launches = 0
        kf, vf = (t.transpose(1, 2).detach().requires_grad_(True)
                  for t in (k, v))
        outs, dqs = [], []
        for r in range(n):
            ql = q[:, :, r * Sl:(r + 1) * Sl].transpose(1, 2).detach() \
                .requires_grad_(True)
            o = sp_local(ql, kf, vf, r, causal=True, window=window)
            o.backward(do[:, :, r * Sl:(r + 1) * Sl].transpose(1, 2))
            outs.append(o.detach().transpose(1, 2))
            dqs.append(ql.grad.transpose(1, 2))
        torch.cuda.synchronize()
        got = {kk: f.launches for kk, f in counters.items()}
        check(got["flash_prefill"] == n and got["flash_prefill_bwd"] == n,
              f"sp {name}: launches {got}, want {n} forward and backward")
        for kk in launches:
            launches[kk] += got[kk]
        pairs = [("out", torch.cat(outs, 2), out),
                 ("dq", torch.cat(dqs, 2), whole[0]),
                 ("dk", kf.grad.transpose(1, 2), whole[1]),
                 ("dv", vf.grad.transpose(1, 2), whole[2])]
        sp_err = {}
        for label, a, b in pairs:
            err = (a.float() - b.float()).abs().max().item()
            top = b.float().abs().max().item()
            check(torch.isfinite(a.float()).all().item() and
                  err <= SP_REL_TOL * top,
                  f"sp {name} {label}: |Δ|={err} > {SP_REL_TOL} x {top}")
            sp_err[label] = err / top
        per_rank = []
        for r in [*range(n), None]:          # each rank, then the whole
            off, rows_q = (0, q) if r is None else \
                (r * Sl, q[:, :, r * Sl:(r + 1) * Sl].contiguous())
            Sq = rows_q.shape[2]
            rdo = do if r is None else \
                do[:, :, r * Sl:(r + 1) * Sl].contiguous()
            okw = dict(kw, pos_offset=off)
            o, ls = flash_prefill(rows_q, k, v, return_lse=True, **okw)
            tile = pick_tile(B, H, Hkv, Sq, D)

            def plain_f():
                return flash_prefill_walk(rows_q, k, v, True, win, S, *tile,
                                          pos_offset=off)

            def plain_b():
                return flash_prefill_bwd_ref(rows_q, k, v, o, ls, rdo, True,
                                             win, S, pos_offset=off)
            ref = plain_f()
            err_f = (o.float() - ref.float()).abs().max().item()
            check(err_f <= FLASH_REL_TOL * ref.float().abs().max().item(),
                  f"sp {name} rank {r}: forward |Δ|={err_f} vs plain")
            g = flash_prefill_bwd(rows_q, k, v, o, ls, rdo, **okw)
            err_b = 0.0
            for gname, a, b in zip(("dq", "dk", "dv"), g, plain_b()):
                e = (a.float() - b.float()).abs().max().item()
                top = b.float().abs().max().item()
                check(e <= FLASH_BWD_REL_TOL * top,
                      f"sp {name} rank {r} {gname}: |Δ|={e} vs plain")
                err_b = max(err_b, e)
            mask = offset_mask(Sq, S, off, window, dev)
            leaves = [t.detach().clone().requires_grad_(True)
                      for t in (rows_q, k, v)]
            sdpa = F.scaled_dot_product_attention
            lib_out = sdpa(*leaves, attn_mask=mask, enable_gqa=Hkv != H)
            ops_f, bytes_f = KC.of_flash_prefill(rows_q, k, v, **okw)
            ops_b, bytes_b = KC.of_flash_prefill_bwd(rows_q, k, v, o, ls,
                                                     rdo, **okw)
            bf, byf = bound_ms(bytes_f, ops_f)
            bb, byb = bound_ms(bytes_b, ops_b)
            row = dict(
                shape=f"sp {name} rank {'whole' if r is None else r}/{n} "
                      f"offset {off} Sq={Sq} Sk={S} H={H} Hkv={Hkv} D={D} "
                      f"window={window}",
                fwd=dict(max_abs_err=err_f,
                         ms=time_ms(lambda: flash_prefill(
                             rows_q, k, v, **okw), flush),
                         plain_ms=time_ms(plain_f, flush, iters=3),
                         library_ms=time_ms(lambda: sdpa(
                             rows_q, k, v, attn_mask=mask,
                             enable_gqa=Hkv != H), flush),
                         bound_ms=bf, bound_by=byf, bytes=bytes_f,
                         ops=ops_f, ops_per_s=HW.peak_flops),
                bwd=dict(max_abs_err=err_b,
                         ms=time_ms(lambda: flash_prefill_bwd(
                             rows_q, k, v, o, ls, rdo, **okw), flush),
                         plain_ms=time_ms(plain_b, flush, iters=3),
                         library_ms=time_ms(lambda: torch.autograd.grad(
                             lib_out, leaves, rdo, retain_graph=True),
                             flush),
                         bound_ms=bb, bound_by=byb, bytes=bytes_b,
                         ops=ops_b, ops_per_s=HW.peak_flops))
            per_rank.append(row)
            lines.append(dict(card=smi, shape=row["shape"], **{
                f"{p}_{m}": row[p][m] for p in ("fwd", "bwd")
                for m in ("ms", "bound_ms", "bound_by", "library_ms",
                          "plain_ms")}))
        ranks = per_rank[:-1]
        for part, out_rows in (("fwd", fwd_rows), ("bwd", bwd_rows)):
            rs = [x[part] for x in ranks]
            libs = [x["library_ms"] for x in rs]
            out_rows.append(dict(
                shape=f"sp {name}: {n} ranks at offsets 0..{S - Sl} "
                      f"(sums over ranks)",
                max_abs_err=max(x["max_abs_err"] for x in rs),
                ms=sum(x["ms"] for x in rs),
                plain_ms=sum(x["plain_ms"] for x in rs),
                library_ms=sum(libs), bound_ms=sum(x["bound_ms"] for x in rs),
                bound_by=bound_ms(sum(x["bytes"] for x in rs),
                                  sum(x["ops"] for x in rs))[1],
                bytes=sum(x["bytes"] for x in rs),
                ops=sum(x["ops"] for x in rs), ops_per_s=HW.peak_flops,
                sp_rel_err=sp_err))
    return lines, fwd_rows, bwd_rows, launches


def sharded_train_check(dev):
    """``launch.train.train_sharded`` on a 1 x 1 NCCL mesh (world size 1
    through ``dist.HashStore``, no port) against ``train()``, both from
    the same seed: full-size smollm-360m, ``SHARDED_TRAIN`` AdamW steps;
    the launch counters zeroed just before the sharded run and read just
    after (one forward and one backward flash launch a layer and step).
    The process group is destroyed afterwards."""
    import math
    import torch
    import torch.distributed as dist
    from repro_torch.configs import get_config
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.train import train_sharded
    from repro_torch.training.loop import train
    arch, steps, batch, seq = SHARDED_TRAIN
    cfg = get_config(arch)
    ref = train(cfg, n_steps=steps, batch=batch, seq=seq, lr=3e-4, seed=0,
                log_every=1, device=dev)
    single = [v for _, v in ref["losses"]]
    counters = launch_counters()
    dist.init_process_group("nccl", store=dist.HashStore(), world_size=1,
                            rank=0)
    try:
        mesh = make_mesh((1, 1), "cuda")
        for f in counters.values():
            f.launches = 0
        res = train_sharded(cfg, mesh, n_steps=steps, batch=batch, seq=seq,
                            lr=3e-4, seed=0, log_every=1, device=dev)
        torch.cuda.synchronize()
        launches = {k: f.launches for k, f in counters.items()}
    finally:
        dist.destroy_process_group()
    want = {k: 0 for k in launches}
    want["flash_prefill"] = want["flash_prefill_bwd"] = cfg.n_layers * steps
    check(launches == want, f"sharded step: launches {launches} != {want}")
    sharded = res["losses"]
    diff = max(abs(a - b) for a, b in zip(sharded, single))
    check(len(sharded) == steps and all(math.isfinite(v) for v in sharded)
          and diff <= TRAIN_TOL_LOSS,
          f"sharded step: losses {sharded} vs train() {single}")
    return dict(arch=cfg.name, mesh=[1, 1], steps=steps, batch=batch,
                seq=seq, losses=sharded, single_device_losses=single,
                bitwise=sharded == single, max_abs_diff=diff,
                step_ms=[t * 1e3 for t in res["step_s"]],
                single_device_step_ms=[t * 1e3 for t in ref["step_s"]],
                launches=launches)


def multidevice_phase(dev, smi):
    """Multi-device launch on the one card: sequence-parallel prefill
    rank by rank at full width (``sp_rows``) and the sharded train step
    on a 1 x 1 NCCL mesh (``sharded_train_check``).  Returns the printed
    lines, the kernel rows and the launches of both drives."""
    import torch
    flush = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    lines, fwd, bwd, launches = sp_rows(dev, flush, smi)
    del flush
    train = sharded_train_check(dev)
    for k, n in train["launches"].items():
        launches[k] += n
    return lines, train, {"flash_prefill": fwd, "flash_prefill_bwd": bwd}, \
        launches


#: decode attention over a sequence-sharded slab, rank by rank (the
#: sharded serve step's call on a 16-way model axis, whose KV heads never
#: divide it): (label, format, B, Hkv, rep, D, context, ranks, window); every
#: slot at the last position, so each rank's range is full (the dry-run's
#: decode_32k) — gemma3's local layers keep only the last ranks' keys, the
#: others give lse -inf and an output of 0
SEQ_SHARDED_DECODE = [
    ("smollm-360m decode_32k", "kv8", 8, 5, 3, 64, 32768, 16, None),
    ("gemma3-1b decode_32k global", "kv8", 8, 1, 4, 288, 32768, 16, None),
    ("gemma3-1b decode_32k local", "kv8", 8, 1, 4, 288, 32768, 16, 1024)]
#: the ranks' lse-combined output against one whole call, relative to its
#: largest element (each rank's output rounded to bf16 before the f32
#: combine)
SEQ_COMBINE_TOL = 2e-2


def seq_sharded_slab(dev, gen, spec, B, S, Hkv, D):
    """A (B, S, Hkv, Dstore) slab of random tokens stored in ``spec``,
    every cell written (a per-layer view)."""
    import torch
    from repro_torch.core import kvcache as KV
    from repro_torch.core.quantize import quantize_kv
    slab = KV.init_cache(B, S, Hkv, D, spec, device=dev).layer(0)
    for buf, sc in ((slab.k, slab.k_scale), (slab.v, slab.v_scale)):
        for b in range(B):
            g = torch.randn((S, Hkv, D), generator=gen, device=dev)
            q, s = quantize_kv(g.to(torch.bfloat16), spec)
            buf[b].copy_(q)
            sc[b].copy_(s[..., 0])
    return slab


def seq_sharded_rows(dev, flush, smi):
    """Decode attention over a sequence-sharded slab at full width
    (``SEQ_SHARDED_DECODE``): each rank's key range through the kernel at
    its key offset with the lse (the drive, launches counted), each
    against the plain version at the same offset; the ranks' outputs
    combined by their lse against one whole-slab call; the whole call
    without the lse equal, bit for bit, to its outputs with it.  Times
    each rank's call beside its bound and SDPA with the explicit mask over
    the rank's dequantized range.  Returns the printed lines, the kernel
    rows and the launches of the drive."""
    import torch
    import torch.nn.functional as F
    from repro_torch.core.precision import get_policy
    from repro_torch.core.quantize import dequantize_kv
    from repro_torch.kernels import cost as KC
    from repro_torch.kernels.kvattn import kvattn
    from repro_torch.kernels.ref import NO_WINDOW, combine_lse, kvattn_ref
    from repro_torch.roofline import HW
    gen = torch.Generator(device=dev)
    gen.manual_seed(25)
    lines, rows, launches = [], [], 0
    for name, fmt, B, Hkv, rep, D, S, n, window in SEQ_SHARDED_DECODE:
        t0 = time.perf_counter()
        spec = {"kv8": get_policy("w4a16kv8"),
                "kv16": get_policy("w16a16kv16")}[fmt].kv
        slab = seq_sharded_slab(dev, gen, spec, B, S, Hkv, D)
        q = torch.randn((B, Hkv, rep, D), generator=gen, device=dev) \
            .to(torch.bfloat16)
        pos = torch.full((B,), S - 1, dtype=torch.int32, device=dev)
        win = NO_WINDOW if window is None else window
        Sl, bs = S // n, 256
        whole = kvattn(q, slab.k, slab.k_scale, slab.v, slab.v_scale, pos,
                       win, rep, bs, spec)
        w_out, w_lse = kvattn(q, slab.k, slab.k_scale, slab.v, slab.v_scale,
                              pos, win, rep, bs, spec, return_lse=True)
        check(w_out.dtype == torch.float32 and
              torch.equal(whole, w_out.to(torch.bfloat16)),
              f"seq {name}: the whole call's f32 output with the lse does "
              "not round to the output without it")
        parts = []
        for r in range(n):
            sl = slice(r * Sl, (r + 1) * Sl)
            parts.append(tuple(t[:, sl].contiguous() for t in (
                slab.k, slab.k_scale, slab.v, slab.v_scale)))
        kvattn.launches = 0
        outs = [kvattn(q, *p, pos, win, rep, bs, spec, key_offset=r * Sl,
                       return_lse=True) for r, p in enumerate(parts)]
        torch.cuda.synchronize()
        check(kvattn.launches == n,
              f"seq {name}: {kvattn.launches} launches, want {n}")
        launches += n
        comb = combine_lse([o for o, _ in outs], [ls for _, ls in outs])
        top = whole.float().abs().max().item()
        c_err = (comb.float() - whole.float()).abs().max().item()
        check(torch.isfinite(comb.float()).all().item() and
              c_err <= SEQ_COMBINE_TOL * top,
              f"seq {name}: combined |Δ|={c_err} > {SEQ_COMBINE_TOL} x {top}")
        qh = q.reshape(B, Hkv * rep, 1, D)
        rank_rows = []
        for r, (p, (o, ls)) in enumerate(zip(parts, outs)):
            args = (q, *p, pos, win, rep, bs, spec)
            ref, ref_lse = kvattn_ref(q, *p, pos, win, rep, bs, r * Sl, True)
            err = (o.float() - ref.float()).abs().max().item()
            tol = ATTN_REL_TOL * max(ref.float().abs().max().item(), 1e-30)
            check(err <= tol, f"seq {name} rank {r}: |Δ|={err} > {tol}")
            none = torch.isinf(ref_lse)
            check(torch.equal(torch.isinf(ls), none) and
                  (ls[none] < 0).all().item() and
                  (o.float()[none] == 0).all().item(),
                  f"seq {name} rank {r}: rows with no key differ")
            l_err = (ls[~none] - ref_lse[~none]).abs().max().item() \
                if (~none).any() else 0.0
            check(l_err <= 1e-3, f"seq {name} rank {r}: lse |Δ|={l_err}")
            kd, vd = (dequantize_kv(t, sc[..., None], spec)
                      .permute(0, 2, 1, 3).contiguous()
                      for t, sc in ((p[0], p[1]), (p[2], p[3])))
            kpos = r * Sl + torch.arange(Sl, device=dev)
            mask = ((kpos <= S - 1) & (kpos > S - 1 - win))[None, None, None]
            sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
                qh, kd, vd, attn_mask=mask, enable_gqa=True)
            ops, nbytes = KC.of_kvattn(*args, key_offset=r * Sl,
                                       return_lse=True)
            b, by = bound_ms(nbytes, ops)
            rank_rows.append(dict(
                shape=f"seq {name} rank {r}/{n} keys {r * Sl}..{(r + 1) * Sl}"
                      f" {fmt} B={B} Hkv={Hkv} rep={rep} D={D}"
                      f" window={window}",
                max_abs_err=err, lse_max_abs_err=l_err,
                rows_without_keys=int(none.sum().item()),
                ms=time_ms(lambda: kvattn(*args, key_offset=r * Sl,
                                          return_lse=True), flush),
                plain_ms=time_ms(lambda: kvattn_ref(
                    q, *p, pos, win, rep, bs, r * Sl, True), flush, iters=3),
                library_ms=time_ms(sdpa, flush), bound_ms=b, bound_by=by,
                bytes=nbytes, ops=ops, ops_per_s=HW.peak_flops))
        for rr in rank_rows:
            lines.append(dict(card=smi, **{k: rr[k] for k in (
                "shape", "ms", "bound_ms", "bound_by", "library_ms",
                "plain_ms", "max_abs_err", "lse_max_abs_err",
                "rows_without_keys")}))
        rs = rank_rows
        rows.append(dict(
            shape=f"seq {name}: {n} ranks of {Sl} keys (sums over ranks)",
            max_abs_err=max(x["max_abs_err"] for x in rs),
            combined_rel_err=c_err / top,
            ms=sum(x["ms"] for x in rs),
            plain_ms=sum(x["plain_ms"] for x in rs),
            library_ms=sum(x["library_ms"] for x in rs),
            bound_ms=sum(x["bound_ms"] for x in rs),
            bound_by=bound_ms(sum(x["bytes"] for x in rs),
                              sum(x["ops"] for x in rs))[1],
            bytes=sum(x["bytes"] for x in rs), ops=sum(x["ops"] for x in rs),
            ops_per_s=HW.peak_flops))
        print(f"  seq {name}: combined rel err {c_err / top:.3g} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        del slab, parts
    return lines, rows, launches


#: the dry-run's count on a 1-rank mesh against the eager count of the
#: same step on the card: (arch, (seq, batch, kind)) — ROOFLINE_TRAIN's
#: step with remat (the dry-run's), rwkv6-7b's decode step
DRYRUN_COUNTS = [(ROOFLINE_TRAIN[0], (ROOFLINE_TRAIN[2], ROOFLINE_TRAIN[1],
                                      "train")),
                 ("rwkv6-7b", (256, 4, "decode"))]
#: the dry-run's other FLOPs and bytes against the eager count (matmul
#: FLOPs exactly), and its peak against the card's, relative
DRYRUN_COUNT_TOL, DRYRUN_MEM_TOL = 0.01, 0.2
#: production pairs the dry-run's CLI runs, each in a process of its own:
#: (arch, shape, multi-pod)
DRYRUN_PAIRS = [("smollm-360m", "decode_32k", False),
                ("arctic-480b", "train_4k", False),
                ("rwkv6-7b", "long_500k", False),
                ("gemma3-1b", "decode_32k", True)]


def dryrun_cli_start():
    """Start ``python -m repro_torch.launch.dryrun`` for each of
    ``DRYRUN_PAIRS`` (CPU only, no card), all at once; returns the
    processes and their record files."""
    out = ROOT / "build" / "dryrun_smoke"
    out.mkdir(parents=True, exist_ok=True)
    procs = []
    for arch, shape, multi in DRYRUN_PAIRS:
        rec = out / f"{arch}-{shape}-{'2x16x16' if multi else '16x16'}.jsonl"
        rec.unlink(missing_ok=True)
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--out", str(rec)] + \
            (["--multi-pod"] if multi else [])
        procs.append((rec, subprocess.Popen(
            cmd, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True, env=dict(os.environ, PYTHONPATH=str(ROOT / "src"),
                                CUDA_VISIBLE_DEVICES=""))))
    return procs


def dryrun_cli_wait(procs, timeout=600):
    """Each pair's record (its process's exit code checked, the status
    "ok"), the processes stopped either way."""
    recs = []
    try:
        for rec, p in procs:
            log, _ = p.communicate(timeout=timeout)
            check(p.returncode == 0 and rec.exists(),
                  f"dryrun CLI {rec.name}: exit {p.returncode}\n"
                  f"{log[-3000:]}")
            r = json.loads(rec.read_text().splitlines()[-1])
            check(r["status"] == "ok", f"dryrun CLI {rec.name}: {r}")
            recs.append(r)
    finally:
        for _, p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return recs


def dryrun_count_check(dev):
    """``DRYRUN_COUNTS``: the dry-run's count of each step on a 1-rank
    fake mesh (CPU, fake tensors) against the eager count of the same step
    on the card (``roofline.analyze_step``, kernels launched): matmul
    FLOPs exactly, other FLOPs and bytes within ``DRYRUN_COUNT_TOL``; the
    dry-run's ``peak_bytes`` against ``torch.cuda.max_memory_allocated``
    of the step (parameters, state and inputs resident), within
    ``DRYRUN_MEM_TOL``.  The card's peak is taken above what was allocated
    before the step's parameters were made, after a full garbage
    collection: tensors of an earlier step that a reference cycle keeps
    until the collector runs are not the step's."""
    import gc
    import torch
    from repro_torch.configs import get_config
    from repro_torch.core.precision import get_policy
    from repro_torch.launch import dryrun as DR
    from repro_torch.models.registry import build
    from repro_torch.roofline import analyze_step
    from repro_torch.serving.engine import quantize_params
    from repro_torch.training import data as D
    from repro_torch.training import optimizer as O
    from repro_torch.training.loop import make_train_step, tree_map
    out = []
    for arch, (seq, batch, kind) in DRYRUN_COUNTS:
        t0 = time.perf_counter()
        rec = DR.run_pair(arch, (seq, batch, kind), mesh_shape=(1, 1),
                          cfg=get_config(arch))
        t_dry = time.perf_counter() - t0
        cfg = get_config(arch)
        model = build(cfg)
        kw = dict(arch=arch, shape=kind, cfg=cfg, seq=seq, batch=batch,
                  kind=kind)
        gc.collect()
        torch.cuda.empty_cache()
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated(dev)
        if kind == "train":
            params = tree_map(lambda p: p.requires_grad_(True),
                              model.init_params(0, dev))
            opt = O.for_config(cfg)
            state = opt.init(params)
            toks, tgts = next(D.batches(cfg.vocab, batch, seq, 1, seed=1,
                                        device=dev))
            step = make_train_step(model, opt, remat=True)
            args = (params, state, toks, tgts)
        else:
            pol = get_policy(DR.SERVING_POLICY)
            params = quantize_params(model.init_params(0, dev), pol, dev)
            state = model.init_cache(pol, batch, seq, dev)
            toks = torch.ones((batch, 1), dtype=torch.int32, device=dev)
            pos = torch.full((batch,), seq - 1, dtype=torch.int32,
                             device=dev)
            args = (params, pol, toks, state, pos)

            def step(*a):
                with torch.no_grad():
                    return model.decode_step(*a)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        eager = analyze_step(step, *args, **kw).cost
        torch.cuda.synchronize()
        card_peak = torch.cuda.max_memory_allocated(dev) - base
        del params, state, args, step, toks
        gc.collect()
        torch.cuda.empty_cache()
        got = rec["device_counts"]
        label = f"{arch} {kind} {batch} x {seq}"
        check(got["matmul_flops"] == eager.matmul_flops,
              f"dryrun count {label}: matmul FLOPs {got} vs {eager}")
        for k, v in (("other_flops", eager.other_flops),
                     ("bytes", eager.bytes)):
            check(abs(got[k] - v) <= DRYRUN_COUNT_TOL * v,
                  f"dryrun count {label}: {k} {got[k]} vs eager {v}")
        peak = rec["memory"]["peak_bytes"]
        check(abs(peak - card_peak) <= DRYRUN_MEM_TOL * card_peak,
              f"dryrun count {label}: peak {peak} B vs the card's "
              f"{card_peak} B")
        out.append(dict(step=label, dryrun=got, eager=dict(
            matmul_flops=eager.matmul_flops, other_flops=eager.other_flops,
            bytes=eager.bytes), dryrun_peak_bytes=peak,
            card_peak_bytes=card_peak, card_resident_before_bytes=base,
            peak_ratio=peak / card_peak,
            dryrun_s=t_dry, dryrun_record=rec))
    return out


def dryrun_phase(dev, smi):
    """The dry-run's phase: (a) decode attention over a sequence-sharded
    slab rank by rank at full width (``seq_sharded_rows``: the kernel at
    each rank's key offset with the lse, combined), (b) the dry-run's
    count against the card's (``dryrun_count_check``), (c) production
    pairs through the dry-run's CLI (``dryrun_cli_start``, started first:
    they run on the host beside (a) and (b)).  Returns the printed lines,
    the kvattn rows, the launches of (a)'s drive, (b)'s rows and (c)'s
    records."""
    import torch
    t0 = time.perf_counter()
    procs = dryrun_cli_start()
    try:
        flush = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
        lines, rows, launches = seq_sharded_rows(dev, flush, smi)
        del flush
        t_a = time.perf_counter() - t0
        counts = dryrun_count_check(dev)
        t_b = time.perf_counter() - t0 - t_a
    except BaseException:
        for _, p in procs:
            p.kill()
            p.wait()
        raise
    recs = dryrun_cli_wait(procs)
    t_c = time.perf_counter() - t0 - t_a - t_b
    print(f"dryrun phase parts: (a) {t_a:.1f} s, (b) {t_b:.1f} s, (c) "
          f"{t_c:.1f} s more", flush=True)
    return lines, rows, launches, counts, recs


def ptxas_report(log):
    """(kernel<template ints>, registers, spill-store bytes) of every entry
    function in an ``nvcc -Xptxas -v`` log (kernels are templated on the
    KV format code, the head dim and whether it walks sub-tiles, or on
    GEMM tile constants)."""
    out, name, spill = [], "?", 0
    for line in log.splitlines():
        m = re.search(r"entry function '_Z\w*?\d+([A-Za-z]\w*?_kernel)I"
                      r"(\w*?)EEv", line)
        if m:
            args = re.findall(r"(?:Li|Lb|E)(\d+)", m.group(2))
            # anonymous-namespace names carry a file tag ending in digits
            name = f"{re.sub(r'^.*\d', '', m.group(1))}<{', '.join(args)}>"
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out.append((name, int(m.group(1)), spill))
    return out


def summarize(rows, launches, **meta):
    """One kernel's line: sums over its main-path shapes."""
    from repro_torch.roofline import HW
    t_b = sum(r["bytes"] for r in rows) / HW.hbm_bw
    t_o = sum(r["ops"] / r["ops_per_s"] for r in rows)
    libs = [r["library_ms"] for r in rows]
    return dict(meta, launches=launches,
                max_abs_err=max(r["max_abs_err"] for r in rows),
                ms=sum(r["ms"] for r in rows),
                plain_ms=sum(r["plain_ms"] for r in rows),
                bound_ms=sum(r["bound_ms"] for r in rows),
                bound_by="bytes" if t_b >= t_o else "operations",
                library_ms=None if None in libs else sum(libs),
                shapes=rows)


def main() -> int:
    """Run every phase; return the exit code."""
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device — the port's kernels run only on "
              "the card", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels import _build

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")

    t0 = time.perf_counter()
    libs = _build.build_all()
    print(f"built {[p.name for p in libs]} in {time.perf_counter() - t0:.1f} s")
    for p in libs:
        lib = p.stem.split('-')[0]
        for kern, regs, spill in ptxas_report(
                p.with_suffix(".log").read_text()):
            print(f"  {lib} {kern}: {regs} registers, {spill} bytes spilled")
            check(not (spill and spill_checked(lib, kern)),
                  f"{lib} {kern} spills {spill} bytes")

    flush = torch.empty(1 << 30, dtype=torch.uint8, device=dev)
    for _ in range(1000):                 # ~0.4 s of work: clocks up
        flush.zero_()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rows = {**gemm_phase(dev, flush), **attn_phase(dev, flush),
            **flash_phase(dev, flush), **flash_bwd_phase(dev, flush)}
    del flush
    for kern, rs in rows.items():
        for r in rs:
            lib = ("     —    " if r["library_ms"] is None
                   else f"{r['library_ms'] * 1e3:7.1f} us")
            print(f"  {kern:12s} {r['shape']:58s} err {r['max_abs_err']:.3g}"
                  f" kernel {r['ms'] * 1e3:7.1f} us  plain "
                  f"{r['plain_ms'] * 1e3:8.1f} us  library {lib}  bound "
                  f"{r['bound_ms'] * 1e3:6.2f} us ({r['bound_by']})")
            if "tile_sweep_ms" in r:
                print("    tiles:", {t: round(ms * 1e3, 1) for t, ms in
                                     r["tile_sweep_ms"].items()}, "us")
            if "rel_err" in r:
                print(f"    relative errors {r['rel_err']}, lse |Δ| "
                      f"{r['lse_max_abs_err']:.3g}")
            if "plan" in r:
                print(f"    plan {json.dumps(r['plan'])}; kernels (us, "
                      f"one profiled call) {json.dumps(r['kernel_us'])}")
    print(f"kernel phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    moe_worst, flips = moe_reference(dev)
    worst = {**reference_phase(dev), **one_shot_reference(dev),
             **dense_reference(dev), **moe_worst,
             **sinusoidal_reference(dev)}
    print(f"reference: REDUCED logits, card vs CPU, max rel err "
          f"{json.dumps(worst)}; moe routing flips at near-ties "
          f"{json.dumps(flips)} ({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    print(f"moe module: llama4 width, sort ≡ einsum, ms "
          f"{json.dumps(moe_module_check(dev))} "
          f"({time.perf_counter() - t0:.1f} s)")
    print(f"calibration: rwkv6 ck width on the card "
          f"{json.dumps(calibration_check(dev))}")
    t0 = time.perf_counter()
    print(f"training reference: REDUCED, card vs CPU "
          f"{json.dumps(train_reference(dev))} "
          f"({time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    training = train_phase(dev)
    for label, r in training.items():
        print(f"training {label}:", json.dumps(r))
    print(f"training phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    _, totals = serve_phase(dev)
    print(f"serve phase: {time.perf_counter() - t0:.1f} s")
    t0 = time.perf_counter()
    tail_worst, tail_serves = tail_phase(dev, totals)
    for r in tail_serves:
        print("serve:", json.dumps(r))
    print(f"tail phase: d_ff {TAIL_D_FF} REDUCED (w2 a 32-deep K tail), "
          f"card vs CPU, max rel err {json.dumps(tail_worst)} "
          f"({time.perf_counter() - t0:.1f} s)")
    for r in training.values():           # main-path runs of the kernels
        for k, n in r.get("launches", {}).items():
            totals[k] += n
    t0 = time.perf_counter()
    examples, launches = examples_phase()
    print("examples:", json.dumps(examples))
    print(f"examples phase: {time.perf_counter() - t0:.1f} s, launches "
          f"{json.dumps(launches)}")
    for k, n in launches.items():
        totals[k] += n
    t0 = time.perf_counter()
    roofline, launches = roofline_phase(dev)
    for r in roofline:
        print("roofline:", json.dumps(r))
    for r in roofline:
        print(f"  {r['step']:38s} {r['matmul_flops']:.3e} + "
              f"{r['other_flops']:.3e} FLOP  {r['bytes']:.3e} B  model "
              f"{r['model_flops']:.3e}  compute {r['compute_ms']:.3f} ms  "
              f"memory {r['memory_ms']:.3f} ms ({r['dominant']})  measured "
              f"{r['ms']:.2f} ms  mfu {r['mfu']:.4f}  FLOPs "
              f"{r['flops_share']:.4f}  bytes {r['bw_share']:.4f}")
    print(f"roofline phase: {time.perf_counter() - t0:.1f} s, launches "
          f"{json.dumps(launches)}")
    for k, n in launches.items():
        totals[k] += n
    t0 = time.perf_counter()
    lines, sharded, md_rows, launches = multidevice_phase(dev, smi)
    for line in lines:
        print("multidevice sp:", json.dumps(line))
    for line in lines:
        print(f"  {line['shape']:70s} fwd {line['fwd_ms'] * 1e3:8.1f} us "
              f"(bound {line['fwd_bound_ms'] * 1e3:7.2f} "
              f"{line['fwd_bound_by']}, SDPA "
              f"{line['fwd_library_ms'] * 1e3:8.1f})  bwd "
              f"{line['bwd_ms'] * 1e3:8.1f} us (bound "
              f"{line['bwd_bound_ms'] * 1e3:7.2f} {line['bwd_bound_by']}, "
              f"SDPA "
              f"{line['bwd_library_ms'] * 1e3:8.1f})  [{smi}]")
    print("multidevice sharded step:", json.dumps(sharded))
    print(f"multidevice phase: {time.perf_counter() - t0:.1f} s, launches "
          f"{json.dumps(launches)}")
    for k, n in launches.items():
        totals[k] += n
    for k, rs in md_rows.items():
        rows[k] += rs
    t0 = time.perf_counter()
    lines, seq_rows, n_seq, counts, recs = dryrun_phase(dev, smi)
    for line in lines:
        print("dryrun seq-sharded decode:", json.dumps(line))
    for line in lines:
        print(f"  {line['shape']:82s} {line['ms'] * 1e3:7.1f} us (bound "
              f"{line['bound_ms'] * 1e3:6.2f} {line['bound_by']}, SDPA "
              f"{line['library_ms'] * 1e3:7.1f}, plain "
              f"{line['plain_ms'] * 1e3:8.1f})  [{smi}]")
    for r in counts:
        print("dryrun count:", json.dumps(r))
        print(f"  {r['step']}: dry-run peak {r['dryrun_peak_bytes'] / 2**30:.2f}"
              f" GiB vs the card's {r['card_peak_bytes'] / 2**30:.2f} GiB "
              f"(ratio {r['peak_ratio']:.3f}); dry-run {r['dryrun_s']:.1f} s")
    for r in recs:
        print("dryrun pair:", json.dumps(r))
        m, t = r["memory"], r["roofline"]
        print(f"  {r['arch']} {r['shape']} {r['mesh']}: peak "
              f"{m['peak_bytes'] / 2**30:.2f} GiB a device, "
              f"{t['dominant']} (compute {t['compute_s'] * 1e3:.2f} ms, "
              f"memory {t['memory_s'] * 1e3:.2f} ms, collective "
              f"{t['collective_s'] * 1e3:.2f} ms), build {r['lower_s']} s, "
              f"count {r['compile_s']} s")
    print(f"dryrun phase: {time.perf_counter() - t0:.1f} s, launches "
          f"{json.dumps({'kvattn': n_seq})}")
    totals["kvattn"] += n_seq
    rows["kvattn"] += seq_rows

    src = "src/repro_torch/csrc/"
    kernels = [
        summarize(rows["mpgemm_a16"], totals["mpgemm_a16"],
                  name="mpgemm_a16", route="cuda", source=src + "mpgemm.cu",
                  replaces="src/repro/kernels/mpgemm.py:137"),
        summarize(rows["mpgemm_int8"], totals["mpgemm_int8"],
                  name="mpgemm_int8", route="cuda",
                  source=src + "mpgemm_int8.cu",
                  replaces="src/repro/kernels/mpgemm.py:96"),
        summarize(rows["paged_kvattn"], totals["paged_kvattn"],
                  name="paged_kvattn", route="cuda",
                  source=src + "paged_kvattn.cu",
                  replaces="src/repro/kernels/paged_kvattn.py:85"),
        summarize(rows["kvattn"], totals["kvattn"], name="kvattn",
                  route="cuda", source=src + "kvattn.cu",
                  replaces="src/repro/kernels/kvattn.py:147"),
        summarize(rows["flash_prefill"], totals["flash_prefill"],
                  name="flash_prefill", route="cuda",
                  source=src + "flash_prefill.cu",
                  replaces="src/repro/kernels/flashprefill.py:82"),
        # no Pallas kernel: the reference differentiates its XLA walk
        summarize(rows["flash_prefill_bwd"], totals["flash_prefill_bwd"],
                  name="flash_prefill_bwd", route="cuda",
                  source=src + "flash_prefill_bwd.cu",
                  replaces="src/repro/core/attention.py:92"),
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
