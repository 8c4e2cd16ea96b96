"""The cost functions against a count by hand at one shape each."""

import pytest

from gpubench import peaks
from gpubench.costs import encoder, q4_matmul


def test_q4_matmul_at_minilm_qkv():
    m, k, n = 1024, 384, 1152
    assert q4_matmul.ops(m, k, n) == 2 * 1024 * 384 * 1152 == 905969664
    # x and the output in bf16, W at 18 bytes per 32 weights
    assert q4_matmul.nbytes(m, k, n) == (
        2 * 1024 * 384 + 2 * 1024 * 1152 + 384 * 1152 * 18 // 32)
    assert q4_matmul.nbytes(m, k, n) == 3394560
    least = q4_matmul.least_seconds(m, k, n)
    assert least == pytest.approx(max(905969664 / 989e12, 3394560 / 3.35e12))
    assert least == pytest.approx(3394560 / 3.35e12)  # bound by bytes


def test_layer_products():
    assert q4_matmul.layer_products(768, 3072) == (
        (768, 2304), (768, 768), (768, 3072), (3072, 768))


def test_encoder_flops_by_hand():
    # bert-base, one sequence of 100 tokens and one of 20
    d, f, layers = 768, 3072, 12
    dense = 2 * 12 * (4 * 768 * 768 + 2 * 768 * 3072)  # a token
    assert dense == 169869312
    attn = 4 * 12 * 768  # a token, per token of its sequence
    want = 120 * dense + attn * (100 * 100 + 20 * 20)
    assert encoder.flops([100, 20], d, f, layers) == want
    assert encoder.flops_per_sequence(100, d, f, layers) + \
        encoder.flops_per_sequence(20, d, f, layers) == want


def test_peaks():
    assert peaks.BF16_FLOPS == 989e12 and peaks.HBM_BYTES_PER_S == 3.35e12
