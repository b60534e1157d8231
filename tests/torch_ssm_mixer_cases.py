"""Shared by the Mamba2 mixer's kernel tests (``test_torch_ssm.py`` on the CPU, ``test_torch_ssm_card.py``
on the card): the chain's operands as the model gives them, and a distance in representable steps."""

import torch

K = 4  # Mamba2's conv taps
FRONT_ARGS = ("xs", "bmat", "cmat", "dt", "w_conv_x", "b_conv_x", "w_conv_b", "b_conv_b", "w_conv_c",
              "b_conv_c", "dt_bias", "a_log", "conv_x", "conv_b", "conv_c")
FRONT_OUTS = ("xs", "bmat", "cmat", "xbar", "log_da", "conv_x", "conv_b", "conv_c")


def _ordered(t: torch.Tensor) -> torch.Tensor:
    """bf16 or fp32 values as integers that count representable steps (sign-magnitude folded)."""
    bits = t.contiguous().view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32).long()
    top = 1 << (15 if t.dtype == torch.bfloat16 else 31)
    return torch.where(bits < 0, -(bits + top), bits)


def steps_apart(a: torch.Tensor, b: torch.Tensor) -> tuple[float, int]:
    """(share of elements equal bit for bit, largest distance in steps of the dtype) of two bf16 or fp32 tensors."""
    assert a.dtype == b.dtype and a.shape == b.shape, (a.dtype, b.dtype, a.shape, b.shape)
    d = (_ordered(a) - _ordered(b)).abs()
    return float((d == 0).float().mean()), int(d.max())


def mixer_inputs(dev, b, s, h, p, n, state: bool, seed: int = 0) -> dict:
    """The chain's operands as the model gives them: bf16 projections (``xs``, ``bmat``, ``cmat``,
    ``dt``, ``z``, the scan's ``y``), conv weights and biases, fp32 ``dt_bias`` / ``a_log`` /
    ``d_skip`` / ``norm`` scale, and fp32 conv states holding bf16 values (or None)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    ci, bf = h * p, torch.bfloat16

    def rnd(*shape, scale=1.0, dtype=bf):
        return (torch.randn(shape, generator=g, device=dev) * scale).to(dtype)

    def conv_state(width):
        return rnd(b, K - 1, width).float() if state else None

    return {
        "xs": rnd(b, s, ci), "bmat": rnd(b, s, n), "cmat": rnd(b, s, n), "dt": rnd(b, s, h),
        "w_conv_x": rnd(K, ci, scale=0.5), "b_conv_x": rnd(ci, scale=0.1),
        "w_conv_b": rnd(K, n, scale=0.5), "b_conv_b": rnd(n, scale=0.1),
        "w_conv_c": rnd(K, n, scale=0.5), "b_conv_c": rnd(n, scale=0.1),
        "dt_bias": torch.log(torch.expm1(torch.rand(h, generator=g, device=dev) * 0.099 + 0.001)),
        "a_log": torch.log(torch.linspace(1.0, 16.0, h, device=dev)),
        "conv_x": conv_state(ci), "conv_b": conv_state(n), "conv_c": conv_state(n),
        "y": rnd(b, s, h, p), "z": rnd(b, s, ci), "d_skip": 1.0 + rnd(h, scale=0.1, dtype=torch.float32),
        "norm": 1.0 + rnd(ci, scale=0.1, dtype=torch.float32),
    }
