from repro_torch.accelerators.base import Platform
from repro_torch.accelerators.ultratrail import UltraTrailSim
from repro_torch.accelerators.vta import VTASim
from repro_torch.accelerators.tpu_v5e import TPUv5eSim, V5E
from repro_torch.accelerators.torch_device import TorchDevicePlatform

__all__ = [
    "Platform",
    "UltraTrailSim",
    "VTASim",
    "TPUv5eSim",
    "V5E",
    "TorchDevicePlatform",
]
