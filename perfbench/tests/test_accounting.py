"""Operation and byte counts against values worked out by hand."""

import json

import pytest

from perfbench import accounting as acc
from perfbench import core, weights
from perfbench.model import shape_of

TINY = acc.Shape(vocab=10, d_model=4, n_heads=2, head_dim=2, n_layers=3,
                 d_ff=6)


def _shape(name):
    return shape_of(json.loads(
        (core.ROOT / "perfbench" / "configs" / f"{name}.json").read_text()))


def test_parameter_counts():
    # 102400*4096 + 30*(4*4096^2 + 3*4096*11008 + 2*4096) + 4096
    assert _shape("deepseek-llm-7b").n_params == 6_490_935_296
    # 49152*2048 + 24*(4*2048^2 + 3*2048*8192 + 2*2048) + 2048
    assert _shape("smollm2-1.7b").n_params == 1_711_376_384
    # 10*4 + 3*(4*4*4 + 3*4*6 + 2*4) + 4 = 40 + 3*144 + 4
    assert TINY.n_params == 476
    drawn = weights.draw(TINY, 1, "cpu")
    assert sum(t.numel() for _, t in weights.leaves(drawn)) == 476


def test_k1_bound_at_a_prefill():
    t, by = acc.k1_bound(1, 1024, 32, 128, "bf16", True)
    flops = 4 * 32 * 128 * (1024 * 1025 // 2)            # 8,598,323,200
    nbytes = 4 * 1024 * 32 * 128 * 2 + 32 * 1024 * 4      # 33,685,504
    assert flops == 8_598_323_200 and nbytes == 33_685_504
    assert by == "bytes" and t == pytest.approx(nbytes / 3.35e12)


def test_bwd_bounds_at_the_train_shape():
    pairs = 2048 * 2049 // 2
    t, by = acc.bwd_bound(16, 2048, 32, 64, "bf16", True, "dkv")
    assert by == "operations"
    assert t == pytest.approx(2 * 4 * 16 * 32 * 64 * pairs / 989e12)
    t, by = acc.bwd_bound(16, 2048, 32, 64, "bf16", False, "dq")
    assert t == pytest.approx(2 * 3 * 16 * 32 * 64 * 2048 ** 2 / 989e12)


def test_train_flops():
    # 6 * 476 * 2 * 5 + 12 * 3 * 2 * 2 * 25 * 2 / 2
    assert acc.train_flops(476, TINY, 2, 5) == 28560 + 3600
    assert acc.flash_fwd_flops(2, 4, 3, 8) == 4 * 2 * 3 * 16 * 8 / 2


def test_serving_counts():
    mm = 4 * 4 * 4 + 3 * 4 * 6                             # 136 a layer
    assert TINY.layer_matmul_params == mm
    # 2*T*L*mm + L*2*H*T^2*Dh + 2*D*V at T = 5
    assert acc.prefill_flops(TINY, 5) == 2 * 5 * 3 * mm + 3 * 2 * 2 * 25 * 2 \
        + 2 * 4 * 10
    # a token attending 7 rows: 2*L*mm + 4*L*H*Dh*7 + 2*D*V
    assert acc.decode_flops(TINY, 7) == 2 * 3 * mm + 4 * 3 * 4 * 7 + 80
    assert acc.decode_step_flops(TINY, 2, 13) == \
        acc.decode_flops(TINY, 6) + acc.decode_flops(TINY, 7)
    # 476 params * 2 B + 13 rows * (2*3*4*2 B) + 2 new rows + 2 * 10 * 4 B
    assert acc.decode_step_bytes(TINY, 2, 13) == 952 + 13 * 48 + 2 * 48 + 80
