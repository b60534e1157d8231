"""PyTorch and CUDA port of ``repro`` for one NVIDIA H100 (Hopper, sm_90a).

The JAX package ``repro`` is the reference: every module here is held
against its counterpart on the same inputs (``tests/test_torch_*.py``).  The
port imports ``torch`` and numpy, never ``jax`` and never a module of
``repro``; what it needs of ``repro``'s pure-data modules it keeps as its own
copy.  Module names follow ``repro`` so a reader finds each counterpart.

Each Pallas TPU kernel becomes a kernel written by hand for Hopper, under
``kernels/csrc/``, built with ``nvcc`` at first use (``kernels/build.py``).
On a CPU tensor a kernel's wrapper runs its plain PyTorch version; on a CUDA
tensor it launches the kernel or raises.

Entry points (``models.transformer.init_params``, ``launch.serve.generate``,
``python -m repro_torch.launch.serve``, ``api.Campaign`` on ``torch_device``,
``api.PerfOracle`` with the ``"torch"`` backend) run on ``cuda`` unless the
caller asks for ``device="cpu"``; without a card they raise
(``device.resolve_device``).

Ported so far: the serving paths of all six families, dense (qwen2-1.5b
and the other dense configs), ssm (mamba2-780m), moe (olmoe-1b-7b), hybrid
(zamba2-2.7b), vlm (qwen2-vl-2b, M-RoPE) and audio (whisper-medium), with
the flash-attention and SSD-scan kernels and the decode step replayed as a
CUDA graph on the card; the estimation pipeline (``api``: campaign, cache,
oracle, hub; ``core``, the advisor among it), with the card as the measured
platform ``accelerators.torch_device`` and the analytic platforms
``tpu_v5e``, ``ultratrail`` and ``vta``; the measurement runtime
(``runtime``: worker pool, retries, crash-safe journal), the oracle service
(``serving``), the trace report (``obs.report``) and repro-lint
(``analysis``: ``python -m repro_torch.analysis src/repro_torch``).  See
ROADMAP.md for the rest.
"""
