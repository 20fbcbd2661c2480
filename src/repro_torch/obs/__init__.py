"""Unified telemetry layer of the port: metrics, trace spans, path-selection
counters, exporters, SLO reporting, profiling and bench history.

The port's own copy of ``repro.obs``: it imports nothing of the JAX package
(nor ``jax``), and nothing of the rest of ``repro_torch`` but
``repro_torch.tree``, so every layer of the port can instrument itself
without cycles. Names, metric keys (``name{k=v,...}``), the file names
(``snapshot.json``, ``events.jsonl``) and the ``REPRO_OBS`` switch are the
reference's, so either package's ``launch.obs`` reads the other's capture.

* :mod:`repro_torch.obs.metrics` — process-global registry of counters,
  gauges and streaming log-bucket histograms; true no-ops when disabled.
* :mod:`repro_torch.obs.spans`   — nested ``span()`` context manager
  forwarding to ``torch.profiler.record_function``; ``sp.sync`` waits for
  the CUDA work of its tensors.
* :mod:`repro_torch.obs.timing`  — ``time_compiled``/``timed_op`` (first
  call timed apart from the steady state) and ``track_shapes``.
* :mod:`repro_torch.obs.export`  — JSONL event log + snapshot (+ Prometheus
  text) behind the CLIs' ``--metrics-dir``.
* :mod:`repro_torch.obs.report`  — snapshot → per-op SLO table + span tree
  (rendered by ``python -m repro_torch.launch.obs``).
* :mod:`repro_torch.obs.prof`    — the work model of the kernel wrappers,
  roofline-utilization and device-memory gauges (``prof.*``), opt-in
  ``torch.profiler`` trace capture (``--profile-dir``), and the program
  analysis of the dry run: ``lower`` records the local ops one device runs
  in a step on DTensors, ``compiled_cost``/``compiled_memory`` and
  ``analyze_program`` (the reference's ``analyze_hlo``) read it.
* :mod:`repro_torch.obs.history` — append-only per-commit bench history +
  noise-aware regression detection behind ``python -m
  repro_torch.launch.regress``.
* :mod:`repro_torch.obs.html`    — zero-dependency static HTML dashboard
  (``python -m repro_torch.launch.obs --html``).

Counter semantics: the port runs eagerly, so every Python-side increment
fires once per *call*. The reference's path-selection counters
(``core.build``, ``analytics.path``, ``kernels.trace``, …) fire at jit
*trace* time and count traced decisions; here the same keys count calls,
so their totals scale with traffic and only their key sets compare across
packages. Where the reference names its XLA route, the port names its own:
``impl=torch`` for ``impl=xla``, ``path=torch`` for ``path=xla``, and
``kernels.trace{op, route=cuda|plain}`` for ``kernels.trace{op,
interpret}``.
"""
from .export import (configure, emit_event, metrics_dir, prometheus_text,
                     read_events, read_snapshot, snapshot_dict,
                     write_snapshot)
from .history import (append_history, detect_regression, read_history,
                      regress_report)
from .html import render_html
from .metrics import (REGISTRY, Counter, Gauge, Histogram, MetricsRegistry,
                      counter, disable, disabled, enable, enabled, gauge,
                      histogram, parse_key)
from .prof import (analyze_program, compiled_cost, compiled_memory,
                   hw_model, live_memory_stats, lower, parse_program,
                   profile_op, profiled_op, record_memory_gauges,
                   start_trace, stop_trace, trace)
from .spans import current_span, event, span
from .timing import (Stopwatch, reset_shape_tracking, time_compiled,
                     timed_op, track_shapes)

__all__ = [
    "REGISTRY", "Counter", "Gauge", "Histogram", "MetricsRegistry",
    "counter", "gauge", "histogram", "parse_key",
    "enable", "disable", "disabled", "enabled",
    "span", "current_span", "event",
    "Stopwatch", "time_compiled", "timed_op", "track_shapes",
    "reset_shape_tracking",
    "configure", "metrics_dir", "emit_event", "write_snapshot",
    "snapshot_dict", "read_snapshot", "read_events", "prometheus_text",
    "profile_op", "profiled_op", "record_memory_gauges",
    "live_memory_stats", "hw_model",
    "start_trace", "stop_trace", "trace",
    "lower", "compiled_cost", "compiled_memory", "parse_program",
    "analyze_program",
    "append_history", "read_history", "detect_regression",
    "regress_report", "render_html",
]
