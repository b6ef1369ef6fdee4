"""R11 positives: pallas-segmented routing with a forward batch missing
the packed channels."""
import numpy as np

from pdnlp_tpu_torch.ops.attention import routed_impl_cached
from pdnlp_tpu_torch.serve.engine import InferenceEngine  # noqa: F401


def packed_forward_missing_channels(engine, ids, seq):
    impl = routed_impl_cached("auto", seq, segmented=True)
    batch = {
        "input_ids": np.zeros((8, seq), np.int32),
        "attention_mask": np.zeros((8, seq), np.int32),
        "token_type_ids": np.zeros((8, seq), np.int32),
    }
    return engine._jit_forward(engine.params, batch), impl


def packed_forward_comprehension(engine, batch, seq):
    impl = engine.routed_attn(seq, segmented=True)
    fwd = {k: batch[k] for k in ("input_ids", "attention_mask",
                                 "token_type_ids")}
    return engine._jit_forward(engine.params, fwd), impl


def packed_forward_half_channels(engine, batch, seq):
    # segment_ids alone is not enough: without cls_positions the head
    # cannot gather per-segment logits
    impl = routed_impl_cached("auto", seq, segmented=True)
    fwd = {k: batch[k] for k in ("input_ids", "attention_mask",
                                 "token_type_ids", "segment_ids")}
    return engine._jit_forward(engine.params, fwd), impl
