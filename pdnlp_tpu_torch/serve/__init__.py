"""Serving: the classifier engine, dynamic batcher, replica router, int8
weights, offline scorer and metrics; the multi-model fleet (shadow, canary,
degrade), the feedback controller and trace replay; generative decoding (the slot and
paged KV-cache engines, continuous batching, speculative decoding, the
decode router and the disaggregated prefill/decode pools with their KV
handoff); and the ``python -m pdnlp_tpu_torch.serve.cli`` entry point."""
from pdnlp_tpu_torch.serve.batcher import (  # noqa: F401
    DEFAULT_BUCKETS, AdmissionControl, DeadlineExceeded, DynamicBatcher,
    LoadShedError, QueueFullError, pick_bucket, resolve_serve_pack,
    usable_buckets,
)
from pdnlp_tpu_torch.serve.controller import (  # noqa: F401
    KnobSpec, ServeController, default_specs,
)
from pdnlp_tpu_torch.serve.decode import (  # noqa: F401
    DecodeBatcher, DecodeEngine, DecodeRouter, DecodeStream,
    DisaggDecodeRouter, PagedDecodeEngine, PrefillWorker, detokenize,
)
from pdnlp_tpu_torch.serve.engine import InferenceEngine, build_engine  # noqa: F401
from pdnlp_tpu_torch.serve.fleet import (  # noqa: F401
    FleetRouter, ModelSpec, RolloutPlan, ShadowReport, drafter_spec,
    parse_fleet_spec, parse_speculate_spec,
)
from pdnlp_tpu_torch.serve.handoff import (  # noqa: F401
    HandoffChannel, HandoffError, HandoffServer, decode_frame, encode_frame,
)
from pdnlp_tpu_torch.serve.kvpage import KVPagesExhausted  # noqa: F401
from pdnlp_tpu_torch.serve.metrics import (  # noqa: F401
    DecodeMetrics, FleetMetrics, ReplicaMetrics, RouterMetrics,
    ServeMetrics,
)
from pdnlp_tpu_torch.serve.offline import score_file, score_texts  # noqa: F401
from pdnlp_tpu_torch.serve.router import (  # noqa: F401
    ReplicaFailedError, ReplicaRouter,
)
