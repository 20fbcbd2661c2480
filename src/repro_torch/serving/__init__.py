"""Overload-hardened asynchronous query front-end (port of
``repro.serving``).

The bridge from a ragged, bursty request stream to the fixed-shape
batches the sharded ops want, built to stay up, bounded, and honest when
offered load exceeds capacity:

* ``admission`` — bounded queue, per-request deadlines on the shared
  ``robust.Clock``, reject-early (CoDel-style) shedding with explicit
  rejections.
* ``ladder``    — queue-pressure-driven graceful degradation with
  hysteresis: exact ops step down to cheaper honest variants (bounds,
  brackets, greedy frontiers), never silently.
* ``batching``  — pad-and-bucket coalescing into a few fixed shapes,
  copied to the engine's device.
* ``breakers``  — per-shard circuit breakers over hedged liveness
  probes; a slow or stuck shard costs coverage, not queue time.
* ``frontend``  — the pump loop tying it together over an epoch-pinned
  ``ingest.serving.GenerationServer``.

The front-end's CLI is ``repro_torch.launch.frontend``.
"""
from .admission import AdmissionQueue, Answer, Request, ShedError, Ticket
from .batching import BatchRunner
from .breakers import BreakerConfig, ShardBreakers
from .frontend import FrontendConfig, QueryFrontend
from .ladder import DegradeLadder, LadderConfig

__all__ = [
    "AdmissionQueue", "Answer", "Request", "ShedError", "Ticket",
    "BatchRunner", "BreakerConfig", "ShardBreakers",
    "FrontendConfig", "QueryFrontend",
    "DegradeLadder", "LadderConfig",
]
