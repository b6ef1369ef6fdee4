"""Training: setup, steps, the Trainer, the optimizer, the port's own
checkpoint format, and the entry points — ``single`` (one device),
``multi`` (data parallelism, one process per rank) and ``spawn`` (a gang of
``multi`` workers on one machine)."""
