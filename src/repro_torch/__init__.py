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
``python -m repro_torch.launch.serve``) run on ``cuda`` unless the caller asks
for ``device="cpu"``; without a card they raise (``device.resolve_device``).

Ported so far: the serving paths of the dense family (qwen2-1.5b and the
other dense configs) with the flash-attention kernel, and of the ssm family
(mamba2-780m) with the SSD-scan kernel.  See ROADMAP.md for the rest.
"""
