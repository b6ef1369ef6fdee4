"""Data-parallel training over ``torch.distributed`` (``pdnlp_tpu/
parallel``): the process group (``runtime``), the ``("data",)`` mesh
(``mesh``), the collectives, the DDP / ZeRO-3 placement (``sharding``) and
the parallel steps (``execution``)."""
