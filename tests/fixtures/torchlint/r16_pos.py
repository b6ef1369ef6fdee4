"""R16 positives: decode loops that rebuild the KV cache per token (never
executed, AST only)."""
import torch


def greedy_decode(model, decode_step, token, k_cache, v_cache):
    for _ in range(32):
        logits, k_new, v_new = decode_step(model, token, k_cache, v_cache)
        k_cache = torch.cat([k_cache, k_new], dim=2)      # line 9
        v_cache = torch.cat((v_cache, v_new), dim=2)      # line 10
        token = logits.argmax(-1)
    return token


def grow_past(step, x, past):
    x = x.clone()
    while x.numel():
        x, kv = step(x, torch.stack(past))           # line 18: stacked list
        past.append(kv)                              # line 19: appended
    return past


def stacked_rebuild(generate_one, layers_kv, tok):
    for _ in range(8):
        tok, new = generate_one(tok, layers_kv)
        layers_kv = torch.stack([layers_kv, new])    # line 26
    return layers_kv


def paged_decode(paged_decode_step, tok, pages_k, page_table):
    for _ in range(16):
        tok, new_page = paged_decode_step(tok, pages_k, page_table)
        page_table = torch.cat([page_table, new_page])   # line 33
        pages_k = torch.vstack([pages_k, new_page])      # line 34
    return tok
