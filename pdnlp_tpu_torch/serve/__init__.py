"""Classifier serving: engine, dynamic batcher, replica router, int8
weights, offline scorer, metrics, and the ``python -m
pdnlp_tpu_torch.serve.cli`` entry point."""
from pdnlp_tpu_torch.serve.batcher import (  # noqa: F401
    DEFAULT_BUCKETS, AdmissionControl, DeadlineExceeded, DynamicBatcher,
    LoadShedError, QueueFullError, pick_bucket, resolve_serve_pack,
    usable_buckets,
)
from pdnlp_tpu_torch.serve.engine import InferenceEngine, build_engine  # noqa: F401
from pdnlp_tpu_torch.serve.metrics import (  # noqa: F401
    ReplicaMetrics, RouterMetrics, ServeMetrics,
)
from pdnlp_tpu_torch.serve.offline import score_file, score_texts  # noqa: F401
from pdnlp_tpu_torch.serve.router import (  # noqa: F401
    ReplicaFailedError, ReplicaRouter,
)
