"""R4 positive: timing windows around CUDA work with no barrier."""
import time

import torch


def time_step(step, state, batch):
    t0 = time.perf_counter()
    step(state, batch)
    return time.perf_counter() - t0                 # line 10: no sync


def time_loop(model, xs):
    start = time.time()
    for x in xs:
        model(x)
    ms = (time.time() - start) * 1e3               # line 17: no sync
    return ms
