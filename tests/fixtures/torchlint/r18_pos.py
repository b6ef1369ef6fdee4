"""R18 positives: handoff export/import shaped by the live page count
(never executed, AST only)."""
import numpy as np
import torch


def storm_export(export_fn, cache_k, cache_v, table, live, n_pages):
    payloads = []
    for slot in live:
        pages = [p for p in table[slot] if p < n_pages]
        payloads.append(export_fn(cache_k, cache_v, torch.tensor(pages)))  # 11
    return payloads


def sliced_import(engine, slot, pk, pv, dst, n_live):
    return engine.import_pages(slot, pk[:n_live], pv[:n_live], dst)  # line 16


def inline_comp_export(export_fn, cache_k, cache_v, row, n_pages):
    return export_fn(cache_k, cache_v,                      # line 20
                     np.asarray([p for p in row if p < n_pages]))


def filtered_import(import_fn, cache_k, cache_v, pk, pv, row, n_pages):
    dst = list(filter(lambda p: p < n_pages, row))
    import_fn(cache_k, cache_v, pk, pv, dst)                # line 26
