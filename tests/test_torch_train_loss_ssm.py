"""``loss_fn`` and every gradient leaf of reduced mamba2-780m (ssm) against the
reference's (see ``torch_train_parity``).

Bar (relative L2 per leaf), as measured on the CPU: 1.25 x the reference's
own compiled-vs-op-by-op gap, about 3.1e-2, for every leaf but ``d_skip``,
which is held to 2 x that gap.  ``d_skip``'s gradient is a sum over batch,
sequence and head dim (4,096 terms here) of bf16 products, and the
reference reduces it in bf16 (``jax.grad`` of a broadcast multiply sums
4,096 ones to 512, ``test_the_reference_reduces_a_bf16_broadcast_gradient_in_bf16``
below), while the port accumulates in fp32: the reference's two runs
already differ there by 3.1e-2 and the port sits at about 5.1e-2 from its
op-by-op run.
"""

import jax
import jax.numpy as jnp
import pytest

torch = pytest.importorskip("torch")

from torch_train_parity import GRAD_REL_L2, compare, family_bar  # noqa: E402

D_SKIP_FACTOR = 2.0


def test_mamba2_loss_and_gradients_match_the_reference():
    gaps, (loss, jloss, _) = compare("mamba2-780m")
    assert abs(loss - jloss) <= GRAD_REL_L2 * abs(jloss)
    floor = max(c for _, c in gaps.values())
    limit = family_bar(gaps)
    worst = {k: g for k, (g, _) in gaps.items() if g > (D_SKIP_FACTOR * floor if "d_skip" in k else limit)}
    assert not worst, (limit, worst)


def test_the_reference_reduces_a_bf16_broadcast_gradient_in_bf16():
    """Why ``d_skip`` has its own bar: the reference's gradient of
    ``x * d.astype(bf16)[None, None, :, None]`` sums in bf16, the port's in fp32."""
    x = jnp.ones((2, 64, 8, 32), jnp.bfloat16)
    grad = jax.grad(lambda d: jnp.sum((x * d.astype(jnp.bfloat16)[None, None, :, None]).astype(jnp.float32)))
    assert float(grad(jnp.ones(8, jnp.float32))[0]) < 4096
    t = torch.ones((2, 64, 8, 32), dtype=torch.bfloat16)
    d = torch.ones(8, requires_grad=True)
    (t * d.to(torch.bfloat16)[None, None, :, None]).float().sum().backward()
    assert float(d.grad[0]) == 4096
