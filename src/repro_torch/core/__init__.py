"""Core of the reproduction: the Performance-Representative methodology.

Pipeline (paper Fig. 1): parameter sweeps -> Algorithm 1 step widths ->
PR set -> PR sampling + benchmarking -> Random-Forest estimator ->
PR mapping at query time -> building-block / whole-network combination.

Submodules: batch, steps, prs, forest, sweeps, estimator, blocks, network,
advisor.  (Imported lazily by users to avoid import cycles with
repro_torch.accelerators.)  The pipeline's unit of work is the columnar
:class:`~repro_torch.core.batch.ConfigBatch`; dict-based entry points are
exact-parity wrappers around the batched implementations.

The public entry point to this pipeline is :mod:`repro_torch.api`
(``CampaignSpec`` / ``Campaign`` / ``PerfOracle`` / ``EstimatorHub``), which
adds measurement caching, step-width reuse, and estimator persistence.
``estimator.build_estimator``, ``estimator.sampling_curve`` and
``blocks.NetworkEstimator`` remain as deprecated shims.
"""
