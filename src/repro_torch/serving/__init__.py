"""Oracle serving layer: high-throughput estimation as a service.

The runtime subsystem (:mod:`repro_torch.runtime`) scales *training* the PR
estimators; this package scales *querying* them.  One :class:`OracleServer`
loads an :class:`repro_torch.api.EstimatorHub` once, keeps warm per-platform
:class:`repro_torch.api.PerfOracle` instances, and answers concurrent estimation
requests through an admission batcher (coalesced forest passes), an LRU
result cache (canonical-fingerprint keys), and a metrics registry
(latency percentiles, throughput, batch-size histogram, cache hit rate).

    from repro_torch.serving import OracleServer, OracleClient, ServeSpec

    server = OracleServer(spec=ServeSpec(hub_dir="runs/hub"))
    client = OracleClient(server=server)          # in-process
    client.predict("tpu_v5e[gray]", "dense", [{"tokens": 128, ...}])

or over a socket (``python -m repro_torch.launch.serve --serve-oracle --port 7070``):

    client = OracleClient(address=("127.0.0.1", 7070))

Served answers are bitwise identical to direct ``PerfOracle`` calls —
coalescing and caching change wall-clock, never results.
"""

from repro_torch.serving.batcher import (
    AdmissionBatcher,
    DeadlineExceeded,
    OverloadError,
    ServingError,
)
from repro_torch.serving.cache import ResultCache
from repro_torch.serving.metrics import MetricsRegistry
from repro_torch.serving.server import OracleServer, ServeSpec, block_payload, parse_block
from repro_torch.serving.transport import OracleClient, OracleSocketServer

__all__ = [
    "AdmissionBatcher",
    "DeadlineExceeded",
    "MetricsRegistry",
    "OracleClient",
    "OracleServer",
    "OracleSocketServer",
    "OverloadError",
    "ResultCache",
    "ServeSpec",
    "ServingError",
    "block_payload",
    "parse_block",
]
