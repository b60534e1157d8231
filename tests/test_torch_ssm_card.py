"""The Mamba2 mixer's two fused kernels (``csrc/ssm_mixer.cu``) against their plain versions, on the card.

Marked ``card``: each test skips without CUDA.  Run on a machine with the card,
from the repo's root (no JAX there, so without the test directory's conftest):

  PYTHONPATH=src python -m pytest -q --noconftest -p no:cacheprovider tests/test_torch_ssm_card.py

Both versions run on the card on the same bf16 inputs.  The front kernel
(``ops.ssm_conv_gate_in``) rounds where the plain chain rounds, in its order,
so its outputs must equal the plain chain's in at least 99.9 % of elements
and lie within one step of their dtype everywhere, and the new conv buffers
must be equal.  The back kernel (``ops.ssm_gate_norm``) sums the norm's
squares in another order, so it must lie within one bf16 step, with and
without the norm.  Shapes: mamba2-780m's prompt-2k prefill at batch 2,
zamba2-2.7b's widths, and decode steps of 1 and 2 tokens from a conv state.
"""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import ops, ref  # noqa: E402

from torch_ssm_mixer_cases import FRONT_ARGS, FRONT_OUTS, mixer_inputs, steps_apart  # noqa: E402

pytestmark = pytest.mark.card

# name: (batch, seq, heads, head dim, state, conv state given)
SHAPES = {
    "mamba2-780m prompt-2k": (2, 2032, 48, 64, 128, True),
    "zamba2-2.7b": (2, 600, 80, 64, 64, False),
    "decode s1": (32, 1, 48, 64, 128, True),
    "decode s2": (4, 2, 48, 64, 128, True),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA); the mixer's kernels run nowhere else")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", list(SHAPES))
def test_front_kernel_equals_the_plain_chain(cuda, shape):
    b, s, h, p, n, state = SHAPES[shape]
    inp = mixer_inputs(cuda, b, s, h, p, n, state)
    args = [inp[k] for k in FRONT_ARGS]
    before = ops.ssm_conv_gate_in.launches
    got = ops.ssm_conv_gate_in(*args)
    torch.cuda.synchronize()
    want = ref.ssm_conv_gate_in_ref(*args)
    torch.cuda.synchronize()
    assert ops.ssm_conv_gate_in.launches == before + 1
    for name, g, w in zip(FRONT_OUTS[:5], got, want):
        same, steps = steps_apart(g, w)
        assert same >= 0.999 and steps <= 1, f"{name}: {same:.6f} equal, {steps} steps apart at most"
    for name, g, w in zip(FRONT_OUTS[5:], got[5:], want[5:]):
        assert g.dtype == w.dtype and torch.equal(g, w), name


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("norm", [True, False])
def test_back_kernel_within_one_bf16_step(cuda, shape, norm):
    b, s, h, p, n, _ = SHAPES[shape]
    inp = mixer_inputs(cuda, b, s, h, p, n, False, seed=1)
    args = (inp["y"], inp["xs"], inp["z"], inp["d_skip"], inp["norm"] if norm else None, 1e-5)
    before = ops.ssm_gate_norm.launches
    got = ops.ssm_gate_norm(*args)
    torch.cuda.synchronize()
    want = ref.ssm_gate_norm_ref(*args)
    torch.cuda.synchronize()
    assert ops.ssm_gate_norm.launches == before + 1
    assert got.dtype == want.dtype == torch.bfloat16 and got.shape == want.shape
    same, steps = steps_apart(got, want)
    assert steps <= 1, f"{same:.6f} equal, {steps} steps apart at most"


def test_kernels_refuse_what_they_do_not_take(cuda):
    inp = mixer_inputs(cuda, 1, 8, 4, 8, 16, True)
    args = [inp[k] for k in FRONT_ARGS]
    with pytest.raises(TypeError, match="bf16 xs"):
        ops.ssm_conv_gate_in(args[0].float(), *args[1:])
    with pytest.raises(TypeError, match="fp32 conv_x"):
        ops.ssm_conv_gate_in(*args[:12], args[12].bfloat16(), *args[13:])
    odd = torch.empty(args[0].numel() + 1, dtype=torch.bfloat16, device=cuda)[1:].view(args[0].shape)
    with pytest.raises(ValueError, match="16-byte boundary"):
        ops.ssm_conv_gate_in(odd, *args[1:])
    with pytest.raises(RuntimeError, match="no gradient"):
        ops.ssm_gate_norm(inp["y"].requires_grad_(), inp["xs"], inp["z"], inp["d_skip"])
