"""R16 negatives: in-place writes into the preallocated cache, non-cache
concatenation in a decode loop, and one-time assembly outside any decode
loop (never executed, AST only)."""
import torch


def greedy_decode(model, decode_step, token, k_cache, v_cache, pos):
    for _ in range(32):
        logits, k_new, v_new = decode_step(model, token, k_cache, v_cache)
        # THE fix: written in place into the preallocated cache
        k_cache.index_copy_(2, pos, k_new)
        v_cache[:, :, pos] = v_new
        token = logits.argmax(-1)
        pos = pos + 1
    return token


def build_cache_once(k_parts, v_parts):
    # one-time assembly OUTSIDE any decode loop
    k_cache = torch.cat(k_parts, dim=0)
    v_cache = torch.cat(v_parts, dim=0)
    return k_cache, v_cache


def collect_tokens(decode_step, token, state):
    out = token
    for _ in range(4):
        token, state = decode_step(token, state)
        # concatenating the OUTPUT stream is fine: it is not KV state
        out = torch.cat([out, token])
    return out


def batch_loop(ids_batches, score_fn, cache_misses):
    # cache-NAMED values in a loop with no decode dispatch
    for ids in ids_batches:
        cache_misses = torch.cat([cache_misses, score_fn(ids)])
    return cache_misses


def paged_decode(paged_decode_step, tok, pages_k, page_table, slot, row):
    # the paged fix: a FIXED-extent table written in place per attach
    page_table[slot] = row
    for _ in range(16):
        tok, new = paged_decode_step(tok, pages_k, page_table)
        pages_k[:, slot] = new
    return tok


def prefill_layers(layers, x):
    # the prefill's per-layer K/V, stacked once after its layer loop
    ks = []
    for layer in layers:
        x, k = layer(x)
        ks.append(k)
    return x, torch.stack(ks)
