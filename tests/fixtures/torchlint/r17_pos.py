"""R17 positives: speculation dispatch whose shape follows the runtime k
(never executed, AST only)."""
import torch  # noqa: F401


def speculate(draft_step, engine, model, tok, window, kv, pos, nreal):
    a = 0
    for _ in range(16):
        window = draft_step(model, tok, kv)
        logits = engine.verify_ids(window[:, : a + 1], pos, nreal, 4)  # 10
        a = int(logits.argmax())
    return window


def adaptive_draft(draft_step, model, tok, kv, k):
    while tok.numel():
        tok = draft_step(model, tok[:, :k], kv)      # line 17
        k = max(1, k - 1)
    return tok


def verify_tail(verify_chunk, window, kv, start, end):
    for _ in range(8):
        window = verify_chunk(window[:, start:end], kv)   # line 24
        start = end
    return window
