"""The port's three remaining examples (``repro_torch/examples``: quickstart,
mixed_precision_formats, serve_continuous_batching) run on the CPU with
``--device cpu`` and print the reference examples' lines and columns; on
the CPU the kernel wrappers run their plain versions, so quickstart's
kernel-versus-plain rows are the plain versions' differences.  On the card
``chip_smoke.py`` runs the same ``main`` functions with ``--device
cuda``."""
import torch

from repro_torch.examples import (mixed_precision_formats, quickstart,
                                  serve_continuous_batching)

# tiny tensors: one intra-op thread avoids the barrier waits that
# dominate when pytest-xdist workers share the cores
torch.set_num_threads(1)

#: decode attention's bar against its plain path (chip_smoke.ATTN_REL_TOL)
ATTN_REL_TOL = 2 ** -6


def test_quickstart(capsys):
    res = quickstart.main(["--device", "cpu"])
    out = capsys.readouterr().out
    for line in ("policy: w4a16kv8  (weights 4-bit, acts 16-bit, kv 8-bit)",
                 "packed storage: 0.53 bytes/value (bf16 would be 2.0)",
                 "mixed-precision GEMM max err vs dense:",
                 "KV cache dtype: torch.int8, per-(token,head) scales: "
                 "(2, 512, 2)",
                 "decode attention out: (2, 1, 8, 128) torch.bfloat16",
                 "kernel max diff vs plain path:"):
        assert line in out
    assert res["attn_diff"] <= ATTN_REL_TOL * res["attn_scale"]
    assert res["gemm_diff"] <= 2 ** -7 * res["gemm_scale"]


def test_mixed_precision_formats(capsys):
    rows = mixed_precision_formats.main(["--device", "cpu"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].split() == ["format", "prefill_ms", "decode_ms",
                                "w_bytes/val", "top1==kv16"]
    assert [ln.split()[0] for ln in lines[1:]] == \
        mixed_precision_formats.FORMATS == list(rows)
    bpv = {"w16": 2.0, "w8a": 1.0, "w4a": 0.5, "wfp": 1.0}
    for fmt, r in rows.items():
        assert r["finite"] and r["w_bytes_per_val"] == bpv[fmt[:3]]
    assert rows["w16a16kv16"]["top1_agree"] == 1.0


def test_serve_continuous_batching(capsys):
    res = serve_continuous_batching.main(["--device", "cpu"])
    out = capsys.readouterr().out
    fin = res["finished"]
    assert len(fin) == serve_continuous_batching.N_REQUESTS
    assert all(len(o.output_token_ids) == 16 for o in fin)
    # every request after the first maps the 24-token system prompt
    assert res["cached_tokens"] >= 24 * (len(fin) - 4)
    assert len(res["streamed"]) == 8
    for line in ("continuous-batching slots, paged KV", "prefix cache: ",
                 "TTFT:", "latency:", "streaming one seeded request"):
        assert line in out
