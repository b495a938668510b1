"""The frozen peaks and work formulas against hand counts and against the
program's own."""
import pytest

from bench import hw
from bench.reference import model as ref


def test_gemm_by_hand():
    # 16 tokens through mistral's wk: 12288 x 1024 at 4 bits, group 128
    wb = hw.weight_bytes(12288, 1024, 4, 128)
    assert wb == 12288 * 1024 // 2 + 96 * 1024 * 4
    ops, nbytes = hw.gemm(16, 12288, 1024, wb)
    assert ops == 2 * 16 * 12288 * 1024
    assert nbytes == 16 * 12288 * 2 + wb + 16 * 1024 * 2
    assert hw.least_seconds(ops, nbytes) == nbytes / 3.35e12
    assert hw.least_seconds(2 * 989e12, 1.0) == 2.0


@pytest.mark.parametrize("K,N,group", [(12288, 12288, 128), (28672, 12288, 128),
                                       (7168, 4864, 64), (4864, 7168, 128),
                                       (7168, 128, 64), (1056, 960, 32)])
def test_weight_group_is_the_programs(K, N, group):
    from repro_torch.core.precision import get_policy
    from repro_torch.models.common import maybe_quantize
    assert hw.weight_group(K, N) == group == ref.weight_group(K)
    import torch
    w = maybe_quantize(torch.zeros((K, N), dtype=torch.bfloat16),
                       get_policy("w4a16kv8"))
    assert w.group == group


def test_matmul_params_by_hand():
    mistral = dict(d_model=12288, n_heads=96, n_kv_heads=8, d_ff=28672,
                   n_layers=4, vocab=32768)
    per = 2 * 12288 * 12288 + 2 * 12288 * 1024 + 3 * 12288 * 28672
    assert hw.matmul_params(mistral) == 4 * per == 4 * 1_384_120_320
    arctic = dict(d_model=7168, n_heads=56, n_kv_heads=8, d_ff=4864,
                  n_layers=1, vocab=32000, n_experts=128, topk=2,
                  moe_dense_residual=True)
    assert hw.matmul_params(arctic) == (2 * 7168 * 7168 + 2 * 7168 * 1024 +
                                        3 * 3 * 7168 * 4864 + 7168 * 128)
    assert [n for n, _, _ in hw.packed_gemms(arctic)] == \
        ["wq", "wk", "wv", "wo", "ws1", "ws3", "ws2", "router"]


def test_cost_equals_the_programs():
    from repro_torch.kernels import cost
    assert hw.gemm(512, 7168, 4864, 123) == cost.gemm(512, 7168, 4864, 123,
                                                      a8=False)

    class W:
        shape, bits, group = (7168, 4864), 4, 64
    assert hw.weight_bytes(7168, 4864, 4, 64) == cost.weight_bytes(W)
    from repro_torch.roofline.analysis import HW
    assert (hw.PEAK_BF16_FLOPS, hw.HBM_BYTES_PER_S) == (HW.peak_flops,
                                                         HW.hbm_bw)
