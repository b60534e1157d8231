"""The benchmark's frozen yardstick against the program's formulas at the cells' shapes.

``perfbench/costs.py`` copies ``repro_torch/kernels/costs.py`` and
``chip_smoke.py``'s bound so that a later change to the program cannot move
the yardstick; these tests make a drift on either side show.
"""

import importlib.util

import pytest

from perfbench import costs
from perfbench.tests.conftest import ROOT

FLASH = [(8, 4080, 4096, 32, 32, 80, 2, True, 0), (32, 512, 640, 32, 32, 80, 2, True, 0),
         (2, 300, 310, 4, 2, 32, 4, True, 5), (1, 64, 64, 8, 8, 64, 2, False, 0)]
SSD = [(32, 2032, 48, 64, 128, 2, 128, False), (8, 4080, 80, 64, 64, 2, 128, False),
       (4, 4096, 48, 64, 128, 2, 128, False), (2, 300, 4, 32, 16, 4, 64, True)]
SSD_BWD = [(4, 4096, 48, 64, 128, 2, 128, False, False), (2, 300, 4, 32, 16, 4, 64, True, True)]


@pytest.mark.parametrize("args", FLASH)
def test_flash_cost_is_the_programs(args):
    from repro_torch.kernels import costs as program

    assert costs.flash_cost(*args) == program.flash_cost(*args)


@pytest.mark.parametrize("args", SSD)
def test_ssd_cost_is_the_programs(args):
    from repro_torch.kernels import costs as program

    assert costs.ssd_cost(*args) == program.ssd_cost(*args)


@pytest.mark.parametrize("args", SSD_BWD)
def test_ssd_bwd_cost_is_the_programs(args):
    from repro_torch.kernels import costs as program

    assert costs.ssd_bwd_cost(*args) == program.ssd_bwd_cost(*args)


def test_least_time_is_chip_smokes_bound():
    import torch

    spec = importlib.util.spec_from_file_location("chip_smoke_for_costs", ROOT / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    assert (smoke.HBM_BYTES_S, smoke.PEAK_FLOPS) == (costs.HBM_BYTES_S, costs.PEAK_FLOPS)
    for nbytes, flops in ((3.2e9, 1e12), (1e6, 5e14), (7.7e7, 7.6e10)):
        assert smoke._bound(nbytes, flops, torch.bfloat16)[0] == pytest.approx(costs.least_ms(nbytes, flops), rel=1e-12)


def test_model_flops_count_every_product_once():
    """The prefill's FLOPs are 2 x the products' weights a token plus the scans and one head a prompt;
    a training step's are 6 x the weights a token plus the scans' forward and backward."""
    import json

    mamba = json.loads((ROOT / "perfbench/configs/mamba2-780m.json").read_text())["model"]
    layers = 48 * (1536 * (2 * 3072 + 2 * 128 + 48) + 3072 * 1536)
    prefill = costs.ssm_prefill_flops(mamba, 32, 2032)
    assert 2 * layers * 32 * 2032 < prefill < 1.1 * 2 * layers * 32 * 2032
    weights = layers + 1536 * 50288
    step = costs.ssm_train_flops(mamba, 4, 4096)
    assert 6 * weights * 4 * 4096 < step < 1.1 * 6 * weights * 4 * 4096
