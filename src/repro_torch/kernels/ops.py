"""Wrappers around the port's kernels (ported from ``repro.kernels.ops``).

On a CPU tensor a wrapper runs its kernel's plain PyTorch version
(``ref.py``); that is the only reason it takes the plain version.  On a CUDA
tensor it checks device, dtype, shape and contiguity, allocates the output,
launches the hand-written kernel on PyTorch's current stream and raises if
the launch is refused.  There is no fallback from the kernel to the plain
version.  Each wrapper counts its kernel's launches in ``<wrapper>.launches``.

``ops.py`` of the reference pads the head dim to 128 lanes and the sequence
to block multiples for the TPU; the CUDA kernel masks the ragged edge itself,
so nothing is padded here.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.ref import flash_attention_ref

_FLASH_DTYPES = (torch.float32, torch.bfloat16)


def _flash_lib() -> ctypes.CDLL:
    lib = build.load("flash_attention")
    fn = lib.repro_flash_attention_fwd
    fn.argtypes = (
        [ctypes.c_void_p] * 4
        + [ctypes.c_int] * 8
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    fn.restype = ctypes.c_int
    return lib


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    *,
    causal: bool = True,
    q_offset: int = 0,
) -> torch.Tensor:
    """Flash attention: q (B,Sq,H,D), k/v (B,Skv,KVH,D) -> (B,Sq,H,D).

    ``sm_scale`` is D**-0.5.  Keys at or past Skv are masked; with ``causal``
    query row i sees keys at positions <= ``q_offset`` + i.  fp32 or bf16;
    on the card D is a multiple of 8 up to 128.
    """
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"expected 4-d q/k/v, got {tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, d = q.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k/v shape {tuple(k.shape)}/{tuple(v.shape)} does not match q {tuple(q.shape)}")
    skv, kvh = k.shape[1], k.shape[2]
    if kvh == 0 or h % kvh:
        raise ValueError(f"{h} q heads are not a multiple of {kvh} kv heads")
    if q_offset < 0:
        raise ValueError(f"q_offset must be >= 0, got {q_offset}")
    devices = {q.device, k.device, v.device}
    if len(devices) != 1:
        raise ValueError(f"q/k/v on different devices: {devices}")
    if q.device.type == "cpu":
        return flash_attention_ref(q, k, v, causal=causal, q_offset=q_offset)
    if q.device.type != "cuda":
        raise ValueError(f"flash_attention runs on cpu or cuda, not {q.device}")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _FLASH_DTYPES:
        raise TypeError(f"flash_attention takes fp32 or bf16 q/k/v of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if d > 128 or d % 8:
        raise ValueError(f"head dim {d} unsupported: the kernel takes multiples of 8 up to 128")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention needs contiguous q/k/v")
    if sq == 0 or skv == 0 or b == 0:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, k {tuple(k.shape)}")
    o = torch.empty_like(q)
    lib = _flash_lib()
    with torch.cuda.device(q.device):
        err = lib.repro_flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            b, sq, skv, h, kvh, d, int(causal), int(q_offset), d**-0.5,
            int(q.dtype == torch.bfloat16), torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed with cudaError_t {err}")
    flash_attention.launches += 1
    return o


flash_attention.launches = 0
