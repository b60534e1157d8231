"""``loss_fn`` and every gradient leaf of reduced zamba2-2.7b (hybrid) against the
reference's (see ``torch_train_parity``).

Bar (relative L2 per leaf), as measured on the CPU: 1.25 x the reference's own
compiled-vs-op-by-op gap, about 7.6e-2 in ``dt_bias`` (twelve mamba layers
and six shared blocks amplify bf16 steps, as ``test_torch_serve_hybrid.py``
finds for the logits); the port sits at about 7.3e-2, in ``d_skip``.
"""

import pytest

pytest.importorskip("torch")

from torch_train_parity import GRAD_REL_L2, compare, family_bar  # noqa: E402


def test_zamba2_loss_and_gradients_match_the_reference():
    gaps, (loss, jloss, _) = compare("zamba2-2.7b")
    assert abs(loss - jloss) <= GRAD_REL_L2 * abs(jloss)
    limit = family_bar(gaps)
    worst = {k: g for k, (g, _) in gaps.items() if g > limit}
    assert not worst, (limit, worst)
