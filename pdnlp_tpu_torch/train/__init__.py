"""Training: setup, steps, the Trainer, the optimizer, the port's own
checkpoint format, and the entry points — ``single`` (one device),
``multi`` (data parallelism, one process per rank), ``spawn`` (a gang of
``multi`` workers on one machine), ``pretrain`` (masked-LM pretraining and
the supervised stage), ``auto`` (the managed ``AutoTrainer``) and
``accel`` (the ``Accelerator``)."""
