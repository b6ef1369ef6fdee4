"""R4 negative: every window ends in a barrier, or times no launch."""
import time

import torch


def _sync(device):
    torch.cuda.synchronize(device)


def time_step(step, state, batch):
    t0 = time.perf_counter()
    out = step(state, batch)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def time_read(model, x):
    t0 = time.monotonic()
    loss = model(x).sum().item()
    return time.monotonic() - t0, loss


def time_helper(step, state, batch, device):
    t0 = time.perf_counter()
    step(state, batch)
    _sync(device)
    return time.perf_counter() - t0


def time_events(model, x):
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    a.record()
    model(x)
    b.record()
    ms = a.elapsed_time(b)
    return ms, time.perf_counter() - t0


def time_nothing():
    t0 = time.perf_counter()
    return time.perf_counter() - t0


class Busy:
    def _sync(self):
        torch.cuda.synchronize()


def time_busy(busy, step, state, batch):
    t0 = time.perf_counter()
    step(state, batch)
    busy._sync()
    return time.perf_counter() - t0


def wait_for(flag, step):
    t0 = time.monotonic()
    while not flag.is_set() and time.monotonic() - t0 < 60:
        step()
