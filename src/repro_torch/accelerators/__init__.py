from repro_torch.accelerators.base import Platform
from repro_torch.accelerators.torch_device import TorchDevicePlatform

__all__ = [
    "Platform",
    "TorchDevicePlatform",
]
