"""R17 negatives: fixed-width speculation dispatch and lookalikes (never
executed, AST only)."""
import torch  # noqa: F401


def speculate_fixed(draft_step, engine, model, tok, window, kv, pos, nreal):
    # the engine's spelling: a full-width [slots, k+1] window, the real
    # length rides the nreal DATA argument — one graph per configured k
    for _ in range(16):
        window = draft_step(model, tok, kv)
        logits = engine.verify_ids(window, pos, nreal, 4)
        nreal = logits.argmax(-1)
    return window


def literal_slice(engine, window, pos, nreal):
    # a literal bound is one shape, not one per round
    for _ in range(16):
        logits = engine.verify_ids(window[:, :5], pos, nreal, 4)
        window = logits
    return window


def non_spec_slice(decode_step, normalize, model, tok, kv, m):
    # a runtime slice on a NON-speculation call in a decode loop
    for _ in range(16):
        tok = decode_step(model, normalize(tok[:, :m]), kv)
    return tok


def outside_decode_loop(engine, window, pos, nreal, a):
    # a one-off variable-width verify outside any decode loop
    return engine.verify_ids(window[:, : a + 1], pos, nreal, 4)
