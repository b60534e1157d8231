"""Hand-written Hopper kernels, their plain PyTorch versions and wrappers.

``ref.py`` holds the plain versions, ``ops.py`` the wrappers (CPU tensor ->
plain version, CUDA tensor -> kernel or raise), ``build.py`` the ``nvcc``
build of ``csrc/`` and ``csrc/`` the CUDA sources.
"""
