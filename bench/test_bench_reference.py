"""The reference against the program at a small size on the CPU: the
port's decode step, teacher-forced through a paged KV8 pool in the
engine's chunks, on the same raw weights (the tests may import both; the
reference imports nothing of the program)."""
import pytest
import torch

from bench import tiny, weights
from bench.reference.model import Reference, fake_quant

torch.set_num_threads(1)


def program_logits(m, raw, policy_name, stream, chunk):
    """The port's logits for every position of ``stream`` (a chunk, then
    one token a step), as the engine feeds a slot."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core.precision import get_policy
    from repro_torch.models.registry import build
    from repro_torch.serving.engine import quantize_params
    pol = get_policy(policy_name)
    model = build(ModelConfig(**m))
    params = quantize_params(raw, pol, "cpu")
    bps = 16
    cache = model.init_paged_cache(pol, 1, bps, 8, bps, "cpu")
    cache.block_table.copy_(torch.arange(bps, dtype=torch.int32)[None])
    out, p = [], 0
    sizes = [chunk] + [1] * (len(stream) - chunk)
    for n in sizes:
        toks = torch.tensor([stream[p:p + n]])
        logits, _ = model.decode_step(params, pol, toks, cache,
                                      torch.tensor([p], dtype=torch.int32),
                                      max_live=bps * 8)
        out.append(logits[0].float())
        p += n
    return torch.stack(out)


@pytest.mark.parametrize("seed", [0, 2 ** 31 + 5])
def test_reference_follows_the_dense_program(seed):
    c = tiny.cell("mistral123b.chat")
    m, policy = c["config"]["model"], c["config"]["policy"]
    raw = weights.draw(m, seed, "cpu")
    stream = torch.randint(0, m["vocab"], (40,), generator=torch.Generator()
                           .manual_seed(seed % 1000)).tolist()
    got = program_logits(m, raw, policy, stream, 24)
    ref = Reference(m, raw, policy).logits([stream], [range(23, 40)])[0][:, 0]
    scale = ref.abs().max()
    # bf16 activations against float32: a few % of the largest logit
    assert (got - ref).abs().max() < 4e-2 * scale
    # the control's precision (a KV4 pool) is told apart by far
    ref4 = Reference(m, raw, policy, kv_bits=4).logits(
        [stream], [range(23, 40)])[0][:, 0]
    assert (got - ref4).abs().max() > 5 * (got - ref).abs().max()


def test_fake_quant_rounds_half_even_per_row():
    x = torch.tensor([[1.0, -2.0, 3.0, 127.0]])
    q = fake_quant(x, -1, 8)
    assert torch.equal(q, x)
    y = torch.tensor([[2.5, 0.5, 7.0]])
    assert fake_quant(y, -1, 4).tolist() == [[2.0, 0.0, 7.0]]
