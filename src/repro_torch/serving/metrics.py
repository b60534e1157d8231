"""Back-compat shim: the serving metrics moved to :mod:`repro_torch.obs.metrics`.

PR 8 unified the serving registry with pipeline-wide counters, pull-based
gauges, and value histograms; the endpoint/batch API and snapshot keys are
unchanged (plus new ``counters``/``gauges``/``histograms`` sections).  Import
from :mod:`repro_torch.obs` in new code.
"""

from repro_torch.obs.metrics import PERCENTILES, MetricsRegistry

__all__ = ["MetricsRegistry", "PERCENTILES"]
