"""The yardstick's arithmetic against counts worked by hand."""
import numpy as np
import pytest

from gpubench import peaks
from gpubench.reference.data import Packed


def test_needed_pairs_of_one_packed_row():
    # segments of 3 and 2 tokens, then 3 padding slots in an 8-wide row:
    # 3*3 + 2*2 same-segment pairs, and every key for each padding query
    seg = np.array([[1, 1, 1, 2, 2, 0, 0, 0]])
    assert peaks.needed_pairs(seg) == 9 + 4 + 3 * 8


def test_attention_bounds_of_one_shape():
    seg = np.array([[1, 1, 1, 2, 2, 0, 0, 0]])        # B 1, S 8
    N, D = 2, 64
    pairs = 37
    t, by = peaks.attention_fwd_bound(seg, N, D, "bfloat16")
    nbytes = 4 * 1 * 8 * N * D * 2 + 1 * 8 * 4         # q, k, v, o; ids
    flops = 4 * D * N * pairs                           # QK^T and PV
    assert by == "bytes"
    assert t == pytest.approx(max(nbytes / 3.35e12, flops / 989e12))
    t, _by = peaks.attention_bwd_bound(seg, N, D, "float32")
    nbytes = 8 * 8 * N * D * 4 + 8 * 4
    flops = 8 * D * N * pairs
    assert t == pytest.approx(max(nbytes / 3.35e12, flops / 67e12))


def test_packed_row_counts():
    # two documents of 3 and 2 tokens in one row of 8
    ids = [np.array([2, 10, 3], np.int32), np.array([2, 3], np.int32)]
    p = Packed(ids, [1, 4], width=8, cap=4)
    assert p.n == 1
    assert p.row_tokens.tolist() == [5]
    assert p.row_pairs.tolist() == [3 * 3 + 2 * 2]
    assert p.segment_ids[0].tolist() == [1, 1, 1, 2, 2, 0, 0, 0]
    assert p.position_ids[0].tolist() == [0, 1, 2, 0, 1, 0, 0, 0]
    assert p.cls_positions[0].tolist() == [0, 3, 0, 0]
    assert p.label[0].tolist() == [1, 4, 0, 0]


def test_expert_products_bound():
    # one expert, 10 kept rows, H 4, I 8, bf16 (2 bytes)
    t, by = peaks.expert_products_bound([10], 4, 8, "bfloat16")
    rows, H, I, E = 10, 4, 8, 1
    nbytes = 2 * (2 * (rows * H + E * H * I + rows * I)
                  + 2 * (rows * I + E * I * H + rows * H)
                  + (rows * I + rows * H + E * I * H)
                  + (rows * H + rows * I + E * H * I))
    assert nbytes == 2 * (2 * 152 + 2 * 152 + 152 + 152)
    flops = 12 * rows * H * I                  # 6 products of 2*rows*H*I
    assert t == pytest.approx(max(nbytes / 3.35e12, flops / 989e12))


def test_step_flops_of_dense_and_moe_layers():
    cfg = {"hidden_size": 4, "intermediate_size": 8, "num_hidden_layers": 2,
           "num_labels": 3}
    # per token 2 * (4*16 + 2*4*8) = 256 matrix parameters; per example
    # 16 + 12 = 28; attention 12 * H * L per pair
    assert peaks.step_flops(cfg, tokens=10, examples=2, pairs=7) == \
        6.0 * (256 * 10 + 28 * 2) + 12.0 * 4 * 2 * 7
    moe = dict(cfg, moe_experts=4, moe_top_k=2)
    # the top-2 experts' 2 * 4 * 8 each, plus the 4 x 4 gate, per layer
    per_token = 2 * (4 * 16 + 2 * 2 * 4 * 8 + 4 * 4)
    assert peaks.step_flops(moe, tokens=10, examples=2, pairs=7) == \
        6.0 * (per_token * 10 + 28 * 2) + 12.0 * 4 * 2 * 7


def test_share_is_none_without_a_reading():
    assert peaks.share_pct(None, 1.0) is None
    assert peaks.share_pct(1.0, None) is None
    assert peaks.share_pct(0.5, 1.0) == 50.0
