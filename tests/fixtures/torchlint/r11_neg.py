"""R11 negatives: packed channels present, unsegmented routing, and
statically-unknowable key sets."""
import numpy as np

from pdnlp_tpu_torch.ops.attention import routed_impl_cached
from pdnlp_tpu_torch.serve.engine import InferenceEngine  # noqa: F401


def packed_forward_full_channels(engine, batch, seq):
    impl = engine.routed_attn(seq, segmented=True)
    fwd = {k: batch[k] for k in ("input_ids", "attention_mask",
                                 "token_type_ids", "segment_ids",
                                 "position_ids", "cls_positions")}
    return engine._jit_forward(engine.params, fwd), impl


def padded_forward_unsegmented(engine, batch, seq):
    # the padded path: no segmented routing, the bare trio is correct
    impl = routed_impl_cached("auto", seq)
    fwd = {k: batch[k] for k in ("input_ids", "attention_mask",
                                 "token_type_ids")}
    return engine._jit_forward(engine.params, fwd), impl


def packed_forward_shared_constant(engine, batch, seq):
    # keys from a class attribute (the engine's PACKED_CHANNELS idiom):
    # not statically resolvable here — the rule flags provable omissions,
    # not unknowns
    impl = engine.routed_attn(seq, segmented=True)
    fwd = {k: batch[k] for k in engine.PACKED_CHANNELS}
    return engine._jit_forward(engine.params, fwd), impl


def unrelated_dict(engine, seq):
    impl = routed_impl_cached("auto", seq, segmented=True)
    report = {"seq": seq, "impl": impl}  # no input_ids: not a batch
    return report
