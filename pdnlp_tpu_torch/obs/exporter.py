"""Live metrics export: Prometheus ``/metrics``, JSON ``/healthz``, and a
bounded flight-recorder JSONL — the port's copy of
``pdnlp_tpu/obs/exporter.py`` (pure stdlib), so the two packages' scrape
names are the same for the same snapshot.

Snapshots written at exit are post-mortem by design.  A serving pool
under live traffic (or a multi-hour training run) needs the opposite: a
scrape endpoint a dashboard can poll NOW, and a crash-durable trail a
SIGKILL cannot erase.

:class:`MetricsExporter` composes both, entirely OFF the hot path:

- **sources** are named zero-arg callables returning JSON-ready snapshot
  dicts (``ServeMetrics.snapshot``, ``RouterMetrics`` via
  ``router.snapshot``, ``StepBreakdown.summary``, ``TransportStats
  .snapshot``, ``obs.memory`` snapshots...).  They are invoked on the HTTP
  handler's thread at scrape time and on the flight recorder's thread at
  its cadence — the serving/training loop never sees the exporter;
- **``/metrics``** renders every numeric leaf as a Prometheus gauge
  (``pdnlp_<source>_<path>``), with integer-keyed sub-dicts (the router's
  per-replica blocks) becoming labels (``{replica="0"}``) instead of
  exploding the metric namespace;
- **``/healthz``** returns ``{"status": "ok", "uptime_s", "sources"}`` —
  the liveness probe a load balancer wants;
- **flight recorder**: a daemon thread appends one JSON line of all
  snapshots every ``flight_interval_s`` to ``flight_path``, flushed per
  line so a SIGKILL'd process still leaves its last interval's evidence;
  the file is BOUNDED — past ``flight_max_records`` lines it is atomically
  rewritten keeping the newest half (a week-long run cannot fill the disk).

Pure stdlib (``http.server`` + ``threading``); ``port=0`` binds an
ephemeral port (tests), ``port=None`` disables HTTP and keeps only the
flight recorder.
"""
from __future__ import annotations

import json
import os
import re
import threading
import time
from typing import Callable, Dict, List, Optional

_NAME_RE = re.compile(r"[^a-zA-Z0-9_]")

#: container keys whose CHILD KEYS become a label instead of a metric-name
#: segment even when they are not integer-like — the fleet's per-model
#: blocks (``models`` / ``by_model`` keyed by model id) must scrape as
#: ``{model="primary"}`` so one dashboard query compares
#: primary/candidate/cheap tiers instead of matching N metric names —
#: and the disaggregated router's role blocks (``by_pool`` keyed by
#: ``prefill``/``decode``) scrape as ``{pool="prefill"}`` the same way
_LABELED_CONTAINERS = {"models": "model", "by_model": "model",
                       "by_pool": "pool"}


def _metric_name(*parts: str) -> str:
    return "_".join(_NAME_RE.sub("_", str(p)).strip("_")
                    for p in parts if str(p))


def _label_name(container_key: str) -> str:
    """Label for an integer-keyed sub-dict: ``replicas`` -> ``replica``,
    anything else keeps its (singularized) container name."""
    k = _NAME_RE.sub("_", str(container_key)) or "key"
    return k[:-1] if k.endswith("s") and len(k) > 1 else k


def prometheus_lines(source: str, snap, prefix: str = "pdnlp"
                     ) -> List[str]:
    """Flatten one snapshot dict into Prometheus text-format gauge lines.

    Numeric leaves become gauges; bools become 0/1; strings/None are
    skipped (Prometheus carries numbers — the JSON surfaces keep the
    rest).  A dict whose keys are ALL integer-like becomes a label on its
    children; lists label their elements by index."""
    lines: List[str] = []

    def fmt_labels(labels: Dict[str, str]) -> str:
        if not labels:
            return ""
        inner = ",".join(f'{k}="{v}"' for k, v in sorted(labels.items()))
        return "{" + inner + "}"

    def emit(name: str, labels: Dict[str, str], value) -> None:
        if isinstance(value, bool):
            value = int(value)
        lines.append(f"{name}{fmt_labels(labels)} {value}")

    def walk(name: str, labels: Dict[str, str], obj, tail: str) -> None:
        if isinstance(obj, bool) or isinstance(obj, (int, float)):
            emit(name, labels, obj)
        elif isinstance(obj, dict):
            keys = list(obj)
            if tail in _LABELED_CONTAINERS and keys:
                label = _LABELED_CONTAINERS[tail]
                for k, v in obj.items():
                    walk(name, {**labels, label: str(k)}, v, str(k))
            elif keys and all(re.fullmatch(r"-?\d+", str(k))
                              for k in keys):
                label = _label_name(tail)
                for k, v in obj.items():
                    walk(name, {**labels, label: str(k)}, v, tail)
            else:
                for k, v in obj.items():
                    walk(_metric_name(name, k), labels, v, str(k))
        elif isinstance(obj, (list, tuple)):
            for i, v in enumerate(obj):
                walk(name, {**labels, _label_name(tail): str(i)}, v, tail)
        # strings / None: skipped

    walk(_metric_name(prefix, source), {}, snap, source)
    return lines


def prometheus_text(snapshots: Dict[str, Dict],
                    prefix: str = "pdnlp") -> str:
    out: List[str] = []
    for source, snap in sorted(snapshots.items()):
        out += prometheus_lines(source, snap, prefix=prefix)
    return "\n".join(out) + "\n"


def build_from_args(args, sources: Dict[str, Callable[[], Dict]],
                    default_flight_name: str,
                    process_index: int = 0,
                    health_sources: Optional[Dict[str, Callable[[], Dict]]]
                    = None) -> Optional["MetricsExporter"]:
    """``--metrics_port``/``--flight_recorder`` -> a STARTED exporter, or
    None when neither is set — ONE wiring shared by ``Trainer.train`` and
    ``serve.cli`` so the defaults cannot drift.

    The HTTP server binds on rank 0 only (every rank of a one-host gang
    shares the port; rank 1's bind would EADDRINUSE) — other ranks keep
    the per-rank flight recorder.  A bind failure (stale process holding
    the port) degrades with a loud warning instead of killing the run:
    telemetry must never take the workload down."""
    import sys

    port = int(getattr(args, "metrics_port", 0) or 0)
    flight = getattr(args, "flight_recorder", None)
    if not port and not flight:
        return None
    if not flight:
        flight = os.path.join(getattr(args, "output_dir", "output"),
                              "telemetry", default_flight_name)
    try:
        return MetricsExporter(
            sources,
            port=(port or None) if process_index == 0 else None,
            flight_path=flight,
            health_sources=health_sources).start()
    except OSError as e:
        print(f"WARNING: metrics exporter disabled — {e} (is the port "
              "held by another run?); the workload continues without "
              "live export", file=sys.stderr)
        return None


class MetricsExporter:
    """Live ``/metrics`` + ``/healthz`` + flight recorder (module doc).

    ``sources``: ``{name: zero-arg callable -> JSON-ready dict}``.  A
    source that raises is reported as ``{"error": ...}`` instead of
    killing the scrape — one sick subsystem must not blind the rest."""

    def __init__(self, sources: Dict[str, Callable[[], Dict]], *,
                 port: Optional[int] = 0, host: str = "127.0.0.1",
                 flight_path: Optional[str] = None,
                 flight_interval_s: float = 10.0,
                 flight_max_records: int = 2048,
                 health_sources: Optional[Dict[str, Callable[[], Dict]]]
                 = None,
                 prefix: str = "pdnlp"):
        self.sources = dict(sources)
        #: named callables whose SMALL summary dicts ride /healthz — the
        #: at-a-glance state (e.g. the serve controller's knob/hold/revert
        #: summary) a probe wants without parsing the full /metrics dump
        self.health_sources = dict(health_sources or {})
        self.host = host
        self.port = port
        self.prefix = prefix
        self.flight_path = flight_path
        self.flight_interval_s = float(flight_interval_s)
        self.flight_max_records = int(flight_max_records)
        self._flight_lines = 0
        self._server = None
        self._server_thread: Optional[threading.Thread] = None
        self._flight_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._started_at: Optional[float] = None
        self.scrapes = 0

    # ------------------------------------------------------------- collect
    def collect(self) -> Dict[str, Dict]:
        snaps: Dict[str, Dict] = {}
        for name, fn in self.sources.items():
            try:
                snaps[name] = fn()
            except Exception as e:  # noqa: BLE001 — one sick source must
                snaps[name] = {"error": f"{type(e).__name__}: {e}"}
        return snaps

    def prometheus(self) -> str:
        self.scrapes += 1
        return prometheus_text(self.collect(), prefix=self.prefix)

    def healthz(self) -> Dict:
        out = {
            "status": "ok",
            "uptime_s": round(time.monotonic() - self._started_at, 1)
            if self._started_at is not None else 0.0,
            "sources": sorted(self.sources),
            "scrapes": self.scrapes,
            "flight_records": self._flight_lines,
        }
        for name, fn in self.health_sources.items():
            try:
                out[name] = fn()
            except Exception as e:  # noqa: BLE001 — one sick summary must
                out[name] = {"error": f"{type(e).__name__}: {e}"}
        return out

    # ------------------------------------------------------------ lifecycle
    def start(self) -> "MetricsExporter":
        self._started_at = time.monotonic()
        self._stop.clear()
        if self.flight_path and os.path.exists(self.flight_path):
            # resume the bound across restarts: a relaunched process must
            # not treat an already-large recorder file as empty
            try:
                with open(self.flight_path) as f:
                    self._flight_lines = sum(1 for _ in f)
            except OSError:
                pass
        if self.port is not None and self._server is None:
            self._server = self._build_server()
            self.port = self._server.server_address[1]
            self._server_thread = threading.Thread(
                target=self._server.serve_forever, daemon=True,
                name="pdnlp-metrics-http")
            self._server_thread.start()
        if self.flight_path and self._flight_thread is None:
            self._flight_thread = threading.Thread(
                target=self._flight_loop, daemon=True,
                name="pdnlp-flight-recorder")
            self._flight_thread.start()
        return self

    def stop(self, final_flight: bool = True) -> None:
        """Shut down; ``final_flight=True`` appends one last snapshot line
        first — the final-metrics-on-every-exit-path contract."""
        self._stop.set()
        if final_flight and self.flight_path:
            try:
                self._flight_append()
            except OSError:
                pass
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._server = None
        if self._server_thread is not None:
            self._server_thread.join(timeout=5)
            self._server_thread = None
        if self._flight_thread is not None:
            self._flight_thread.join(timeout=5)
            self._flight_thread = None

    def __enter__(self) -> "MetricsExporter":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # ---------------------------------------------------------------- http
    def _build_server(self):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        exporter = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self):  # noqa: N802 — http.server API
                if self.path.startswith("/metrics"):
                    body = exporter.prometheus().encode()
                    ctype = "text/plain; version=0.0.4; charset=utf-8"
                elif self.path.startswith("/healthz"):
                    body = (json.dumps(exporter.healthz()) + "\n").encode()
                    ctype = "application/json"
                else:
                    self.send_error(404)
                    return
                self.send_response(200)
                self.send_header("Content-Type", ctype)
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def log_message(self, *args):  # silence per-scrape stderr
                pass

        return ThreadingHTTPServer((self.host, int(self.port)), Handler)

    # ------------------------------------------------------ flight recorder
    def _flight_append(self) -> None:
        line = json.dumps({"t": time.time(), **self.collect()},
                          separators=(",", ":"))
        os.makedirs(os.path.dirname(self.flight_path) or ".", exist_ok=True)
        with open(self.flight_path, "a") as f:
            f.write(line + "\n")
            f.flush()
            os.fsync(f.fileno())
        self._flight_lines += 1
        if self._flight_lines > self.flight_max_records:
            self._flight_truncate()

    def _flight_truncate(self) -> None:
        """Keep the newest half (atomic rewrite): bounded evidence, not a
        disk-filling log."""
        try:
            with open(self.flight_path) as f:
                lines = f.readlines()
        except OSError:
            return
        keep = lines[-(self.flight_max_records // 2):]
        tmp = self.flight_path + ".tmp"
        with open(tmp, "w") as f:
            f.writelines(keep)
        os.replace(tmp, self.flight_path)
        self._flight_lines = len(keep)

    def _flight_loop(self) -> None:
        while not self._stop.wait(self.flight_interval_s):
            try:
                self._flight_append()
            except OSError:
                pass  # a full disk must not kill the recorder thread
