"""Tiny versions of the benchmark's cells, for runs on the CPU: the
cell's own configuration and traffic files at test widths (the port's
``bert-tiny`` / ``bert-tiny-moe`` sizes, a few hundred short documents),
with the cell's own metrics and limits."""
import copy

from gpubench import spec

TINY_MODEL = {"hidden_size": 128, "num_hidden_layers": 2,
              "num_attention_heads": 2, "intermediate_size": 512,
              "max_position_embeddings": 128}


def cell(name: str) -> spec.Cell:
    c = spec.load_cell(name)
    cfg = copy.deepcopy(c.config)
    cfg.update(TINY_MODEL)
    cfg["port"] = dict(cfg["port"], model="bert-tiny-moe"
                       if cfg.get("moe_experts") else "bert-tiny")
    tr = dict(c.traffic, documents=400, heldout_documents=8, max_seq_len=64,
              rows=8)
    return spec.Cell(c.name, c.chips, cfg, tr, c.end_to_end, c.per_layer,
                     c.limits)


def cells():
    import json
    import os

    with open(os.path.join(spec.ROOT, "BENCHMARK.json")) as f:
        return [w["name"] for w in json.load(f)["workloads"]]
