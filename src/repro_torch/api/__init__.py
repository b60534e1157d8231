"""repro_torch.api — the public entry point to the PR-benchmarking pipeline.

Typical flow (the paper's Fig. 1, campaign-level)::

    from repro_torch.api import Campaign, CampaignSpec, EstimatorHub, PerfOracle

    spec = CampaignSpec(platform="torch_device", n_samples=500, hub_dir="hub/")
    oracle = Campaign(spec).run()                  # sweeps -> PRs -> forest
    oracle.predict("dense", [{"tokens": 512, "d_in": 4096, "d_out": 1024}])

    # later / elsewhere: reload without re-measuring anything
    oracle = PerfOracle.load(EstimatorHub("hub/"), "torch_device")

Both measure and predict on the card; ``platform_kwargs={"device": "cpu"}``
and ``run(device="cpu")`` keep a campaign on the CPU.

See README.md for the end-to-end quickstart.
"""

from repro_torch.api.cache import CachedPlatform, MeasurementCache
from repro_torch.api.campaign import Campaign, CampaignSpec, train_layer_estimator
from repro_torch.api.hub import EstimatorHub
from repro_torch.api.oracle import PerfOracle
from repro_torch.api.registry import get_platform, list_platforms, register_platform
from repro_torch.core.batch import BlockBatch, ConfigBatch
from repro_torch.runtime import (
    DegradationReport,
    FaultPlan,
    HealthPolicy,
    MeasurementRuntime,
    RunStats,
    RuntimeSpec,
)

__all__ = [
    "BlockBatch",
    "CachedPlatform",
    "Campaign",
    "CampaignSpec",
    "ConfigBatch",
    "DegradationReport",
    "EstimatorHub",
    "FaultPlan",
    "HealthPolicy",
    "MeasurementCache",
    "MeasurementRuntime",
    "PerfOracle",
    "RunStats",
    "RuntimeSpec",
    "get_platform",
    "list_platforms",
    "register_platform",
    "train_layer_estimator",
]
