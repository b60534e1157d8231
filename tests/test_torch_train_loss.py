"""``loss_fn`` and every gradient leaf of reduced qwen2-1.5b (dense), whisper-medium
(audio) and qwen2-vl-2b (vlm) against the reference's (see ``torch_train_parity``).

Bars per family (relative L2 per leaf), as measured on the CPU:

* qwen2-1.5b and whisper-medium: 2e-2 (the port at about 1.7e-2 and 1.0e-2);
* qwen2-vl-2b: 1.25 x the reference's own compiled-vs-op-by-op gap, about
  2.8e-2 in the attention biases' gradients (the port at about 2.7e-2).
"""

import pytest

pytest.importorskip("torch")

from torch_train_parity import GRAD_REL_L2, compare, family_bar  # noqa: E402


@pytest.mark.parametrize("arch,bar", [("qwen2-1.5b", "2e-2"), ("whisper-medium", "2e-2"),
                                      ("qwen2-vl-2b", "floor")])
def test_loss_and_gradients_match_the_reference(arch, bar):
    gaps, (loss, jloss, _) = compare(arch)
    assert abs(loss - jloss) <= GRAD_REL_L2 * abs(jloss)
    limit = GRAD_REL_L2 if bar == "2e-2" else family_bar(gaps)
    worst = {k: g for k, (g, _) in gaps.items() if g > limit}
    assert not worst, (limit, worst)
