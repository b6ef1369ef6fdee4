"""Inline ``# torchlint: disable=`` markers silence exactly what they name."""
import torch

POOL = torch.cuda.graph_pool_handle()


def same_line(graph, x):
    with torch.cuda.graph(graph, pool=POOL):
        return x.item()  # torchlint: disable=R1 — read once by design


def comment_line(graph, x):
    with torch.cuda.graph(graph, pool=POOL):
        # torchlint: disable=R1
        return x.item()


def wrong_id(graph, x):
    with torch.cuda.graph(graph, pool=POOL):
        return x.item()  # torchlint: disable=R2 (wrong rule: still fires)


def disable_all(graph, x):
    with torch.cuda.graph(graph, pool=POOL):
        return x.item()  # torchlint: disable=all


def jax_marker_is_not_ours(graph, x):
    with torch.cuda.graph(graph, pool=POOL):
        return x.item()  # jaxlint: disable=R1
