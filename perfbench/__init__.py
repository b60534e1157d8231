"""The benchmark of the PyTorch/CUDA port (``repro_torch``); ``python3 perfbench/run.py --help``."""
