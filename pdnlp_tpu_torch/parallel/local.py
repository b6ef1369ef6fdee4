"""Local gangs: several ranks of the data-parallel path on one machine,
driven from a function — for checks and measurements that need the ranks'
numbers back, where the entry points print lines.

- :func:`run_gang` runs ``fn(rank, world, args, payload)`` in ``world``
  fresh processes (``multiprocessing``'s ``spawn``), joined by
  ``parallel.runtime.init_runtime`` through a ``file://`` rendezvous of
  their own (no port to collide with another gang), and returns each
  rank's result.  A rank that raises, or a gang past ``timeout``, stops
  the whole gang and raises here with the rank's traceback.
- :func:`train_global_batches` is such an ``fn``: each strategy of
  ``payload["runs"]`` trains from the seeded weights on the same global
  batches, every rank on its contiguous block of each (as ``P("data")``
  splits a batch), and reports the global losses, each step's kernel
  launches in this rank, whether the ranks' weights are bit-equal, the
  shard fraction and the eval outputs gathered over the ranks; rank 0
  writes each run's consolidated weights to a file.
"""
from __future__ import annotations

import hashlib
import os
import queue
import tempfile
import time
import traceback
from typing import Callable, Dict, List

import numpy as np
import torch


def _rank_main(fn, rank, world, args, payload, rdzv, results, threads):
    from pdnlp_tpu_torch.parallel.runtime import init_runtime, shutdown

    try:
        if threads:
            torch.set_num_threads(threads)
        init_runtime(args.replace(coordinator_address=f"file://{rdzv}",
                                  num_processes=world, process_id=rank))
        try:
            results.put((rank, True, fn(rank, world, args, payload)))
        finally:
            shutdown()
    except BaseException:  # reported to the parent, which stops the gang
        results.put((rank, False, traceback.format_exc()))


def run_gang(fn: Callable, world: int, args, payload=None,
             timeout: float = 600.0) -> List:
    """``[fn(rank, world, args, payload) for each rank]``, computed by
    ``world`` processes that form one process group (``args.device`` and
    ``args.dist_backend`` pick the card and the backend).  On the CPU the
    ranks split the cores between them."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    threads = 0 if args.device.startswith("cuda") \
        else max(1, (os.cpu_count() or 1) // world)
    with tempfile.TemporaryDirectory(prefix="pdnlp_gang_") as tmp:
        procs = [ctx.Process(target=_rank_main,
                             args=(fn, r, world, args, payload,
                                   os.path.join(tmp, "rdzv"), results,
                                   threads))
                 for r in range(world)]
        for p in procs:
            p.start()
        out: Dict[int, object] = {}
        deadline = time.monotonic() + timeout
        try:
            while len(out) < world:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise RuntimeError(f"gang of {world} timed out after "
                                       f"{timeout:.0f} s")
                try:
                    rank, ok, value = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [p.exitcode for p in procs
                            if p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"a rank of the gang died (exit "
                                           f"{dead[0]}) without a result")
                    continue
                if not ok:
                    raise RuntimeError(f"rank {rank} failed:\n{value}")
                out[rank] = value
        finally:
            for p in procs:
                p.join(timeout=max(1.0, deadline - time.monotonic()))
                if p.is_alive():
                    p.kill()
                    p.join()
    return [out[r] for r in range(world)]


def rank_block(batch: Dict[str, np.ndarray], rank: int, world: int
               ) -> Dict[str, np.ndarray]:
    """Rank ``rank``'s contiguous block of a global batch's rows."""
    rows = len(batch["example_weight"])
    if rows % world:
        raise ValueError(f"a {rows}-row batch does not split over {world} "
                         "ranks")
    n = rows // world
    return {k: v[rank * n: (rank + 1) * n] for k, v in batch.items()}


def params_digest(model: torch.nn.Module) -> str:
    """A hash of this rank's weights, bit for bit."""
    h = hashlib.sha256()
    for name, p in model.state_dict().items():
        local = p.to_local() if hasattr(p, "to_local") else p
        h.update(name.encode())
        h.update(local.detach().cpu().contiguous().view(torch.uint8)
                 .numpy().tobytes())
    return h.hexdigest()


def train_global_batches(rank: int, world: int, args, payload: Dict) -> List:
    """For each run of ``payload["runs"]`` (``{"name", "mode",
    "explicit_collectives", "compress_grads", "batches", "eval_batch",
    **Args overrides}``; ``batches`` and ``eval_batch`` default to the
    payload's): set up the placed train state from ``args``'s seed, train
    one step per global batch (numpy), then run the eval step on the eval
    batch, if any.  Returns per run: ``losses`` and
    ``accuracies`` (global), ``launches`` (this rank's kernel launches,
    step by step), ``step_ms`` (host clock to a sync, after the first
    step), ``digests`` (every rank's :func:`params_digest`),
    ``shard_fraction``, ``eval`` (the gathered ``pred``, ``label`` and
    ``ew``) and ``allreduce_ms``: with ``payload["allreduce_numel"]``, the
    times of three all-reduces of that many fp32 values before the runs
    (host clock to a sync); rank 0 writes the consolidated weights to
    ``payload["out_dir"]/<name>.pt`` (``checkpoint.save_params``)."""
    import torch.distributed as dist

    from pdnlp_tpu_torch.data.pipeline import to_device
    from pdnlp_tpu_torch.ops import flash, fused_ce
    from pdnlp_tpu_torch.parallel import collectives
    from pdnlp_tpu_torch.parallel.execution import (
        make_parallel_eval_step, make_parallel_train_step,
        make_shardmap_train_step, setup_sharded_model,
    )
    from pdnlp_tpu_torch.parallel.mesh import make_mesh
    from pdnlp_tpu_torch.parallel.sharding import shard_fraction
    from pdnlp_tpu_torch.train import checkpoint as ckpt

    def counts():
        return {**{k: flash.launch_count(k) for k in flash.KERNELS},
                **{k: fused_ce.launch_count(k) for k in fused_ce.KERNELS}}

    device = torch.device("cuda", torch.cuda.current_device()) \
        if args.device.startswith("cuda") else torch.device("cpu")

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    mesh = make_mesh(device_type=device.type)
    allreduce_ms = None
    if payload.get("allreduce_numel"):
        buf = torch.ones(int(payload["allreduce_numel"]), device=device)
        allreduce_ms = []
        for _ in range(4):                    # the first call warms up
            sync()
            t = time.perf_counter()
            dist.all_reduce(buf)
            sync()
            allreduce_ms.append((time.perf_counter() - t) * 1e3)
        allreduce_ms = allreduce_ms[1:]
        del buf
    out = []
    for run in payload["runs"]:
        run = dict(run)
        name = run.pop("name")
        batches = run.pop("batches", None) or payload["batches"]
        eval_batch = run.pop("eval_batch", payload.get("eval_batch"))
        mode = run.pop("mode", "dp")
        explicit = run.pop("explicit_collectives", False)
        compress = run.pop("compress_grads", True)
        rargs = args.replace(**run)
        cfg, state = setup_sharded_model(
            rargs, payload["vocab_size"], mesh, mode,
            total_steps=len(batches), explicit_collectives=explicit)
        step = (make_shardmap_train_step(rargs, mesh, device, compress)
                if explicit else make_parallel_train_step(rargs, mesh,
                                                          device))
        losses, accs, launches, t0 = [], [], [], None
        for i, host in enumerate(batches):
            if i == 1:
                sync()
                t0 = time.perf_counter()
            before = counts()
            m = step(state, to_device(rank_block(host, rank, world), device))
            after = counts()
            launches.append({k: after[k] - before[k] for k in after})
            losses.append(m["loss"])
            accs.append(m["accuracy"])
        sync()
        step_ms = ((time.perf_counter() - t0) / (len(batches) - 1) * 1e3
                   if t0 is not None else None)
        rec = {"name": name, "allreduce_ms": allreduce_ms,
               "losses": [float(x) for x in losses],
               "accuracies": [float(x) for x in accs],
               "launches": launches, "step_ms": step_ms,
               "shard_fraction": shard_fraction(state.model,
                                                state.optimizer)}
        digest = params_digest(state.model)
        digests = [None] * world
        dist.all_gather_object(digests, digest)
        rec["digests"] = digests
        if eval_batch is not None:
            ev = make_parallel_eval_step(rargs, state)
            m = ev(state.model, None, to_device(
                rank_block(eval_batch, rank, world), device))
            rec["eval"] = [a.cpu().numpy() for a in collectives.output_reduce(
                m["pred"], m["label"], m["ew"])]
        params = ckpt.consolidate(state.model)
        if rank == 0 and payload.get("out_dir"):
            path = os.path.join(payload["out_dir"], f"{name}.pt")
            ckpt.save_params(path, params, model_name=rargs.model,
                             vocab_size=cfg.vocab_size)
            rec["checkpoint"] = path
        out.append(rec)
        del state, step, params
        if device.type == "cuda":
            torch.cuda.empty_cache()
    return out
