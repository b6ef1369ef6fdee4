"""R18 negatives: the fixed-width padded handoff and varlen data that never
reaches a program's shape (never executed, AST only)."""
import numpy as np
import torch


def padded_export(export_fn, cache_k, cache_v, table, slot):
    # the engine's form: the FULL table row, sentinel-padded — one shape
    src = torch.as_tensor(table[slot], dtype=torch.int32)
    return export_fn(cache_k, cache_v, src)


def sentinel_export(export_fn, cache_k, cache_v, pages_per_stream, n_pages):
    src = np.full((pages_per_stream,), n_pages, np.int32)
    return export_fn(cache_k, cache_v, src)


def literal_slice_import(import_fn, cache_k, cache_v, pk, pv, dst):
    return import_fn(cache_k, cache_v, pk, pv, dst[:8])


def count_as_data(export_fn, cache_k, cache_v, table, slot, n_pages):
    # the runtime count rides as SCALAR data the program masks on
    pages = [p for p in table[slot] if p < n_pages]
    return export_fn(cache_k, cache_v, np.asarray(table[slot]), len(pages))


def varlen_outside_handoff(score_fn, table, slot, n_pages):
    pages = [p for p in table[slot] if p < n_pages]
    return score_fn(np.asarray(pages))


def engine_handoff(engine, slot, payload_k, payload_v):
    # the engine's own entry points: the full row is built inside
    k, v = engine.export_pages(slot)
    engine.import_pages(slot, payload_k, payload_v)
    return k, v
