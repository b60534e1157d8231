"""Wrappers around the port's kernels (ported from ``repro.kernels.ops``).

On a CPU tensor a wrapper runs its kernel's plain PyTorch version
(``ref.py``); that is the only reason it takes the plain version.  On a CUDA
tensor it checks device, dtype, shape and contiguity, allocates the output,
launches the hand-written kernel on PyTorch's current stream and raises if
the launch is refused.  There is no fallback from the kernel to the plain
version.  Each wrapper counts its kernel's launches in ``<wrapper>.launches``.
A CUDA-graph replay (``generate``'s decode step) goes through no wrapper, so
no counter counts it; the decode step launches neither attention nor scan
kernel (one query takes ``full_attention``, and mamba2 decodes by its
recurrence), but its mamba layers do launch the mixer's two kernels
(``ssm_conv_gate_in``, ``ssm_gate_norm``), counted while the graph is
recorded and not in its replays.

The grouped expert products of the dropless MoE (``moe_grouped_mm``) run in
the prefill and in the decode step alike (counted, like the mixer's, in the
prefill, the decode step's eager warm-up and its recording).

Each launch but the grouped products' is also a ``torch.library.custom_op``
(``repro_torch::flash_attention``, ``repro_torch::ssd_scan_fwd``,
``repro_torch::ssd_scan_bwd``, ``repro_torch::ssm_conv_gate_in``,
``repro_torch::ssm_gate_norm``) whose body is
the ctypes launch above, so the dispatcher can trace it: each has a fake
implementation (shapes only; a fake tensor computes nothing and reaches no
plain version); the attention's and the scan's also have a FLOP formula from
``costs.py`` (``torch.utils.flop_counter`` and the dry run count the work the
bounds count; it counts no elementwise op, the mixer's kernels included) and
``SCRATCH_BYTES``, the device scratch their kernels allocate beside their
outputs.  A wrapper goes
through the op only when something watches the dispatcher (``_dispatched``:
a dispatch mode such as fake tensors or FLOP counting, or a tensor subclass
such as a DTensor); plain CUDA tensors call the launch directly, as before
the ops existed, and skip the op's Python dispatch.  Under sharding
rules the models call them through ``distributed.local_call`` on each
rank's heads (and batch), so the ops themselves see local tensors.  The
dropless MoE runs on one device only and is traced by no dry-run cell, so
its grouped products launch directly.

``ops.py`` of the reference pads head dims and state widths to 128 lanes and
sequences to block or chunk multiples for the TPU; the CUDA kernels mask the
ragged edge themselves, so nothing is padded here.
"""

from __future__ import annotations

import ctypes

import torch

from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build, costs
from repro_torch.kernels.ref import (
    flash_attention_ref,
    moe_grouped_mm_ref,
    ssd_scan_bwd_ref,
    ssd_scan_ref,
    ssm_conv_gate_in_ref,
    ssm_gate_norm_ref,
)

_FLASH_DTYPES = (torch.float32, torch.bfloat16)
_SSD_DTYPES = (torch.float32, torch.bfloat16)
_SSD_CHUNKS = (64, 128)


def _dispatched(*tensors) -> bool:
    """Whether a launch must go through its custom op: a dispatch mode is on
    (fake tensors, FLOP counting) or an input is a tensor subclass."""
    return torch._C._len_torch_dispatch_stack() > 0 or any(
        t is not None and type(t) is not torch.Tensor for t in tensors)


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
    on the card D is a multiple of 8 up to 128, and bf16 q/k/v start on a
    16-byte boundary (the tensor-core kernel copies 16 bytes at a time).
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
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "flash_attention has no gradient: neither the JAX reference nor the port differentiates "
            "the flash route (attention_impl='flash_pallas'); training uses attention_impl="
            "'xla_chunked', the configs' default"
        )
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in _FLASH_DTYPES:
        raise TypeError(f"flash_attention takes fp32 or bf16 q/k/v of one dtype, got {q.dtype}/{k.dtype}/{v.dtype}")
    if d > 128 or d % 8:
        raise ValueError(f"head dim {d} unsupported: the kernel takes multiples of 8 up to 128")
    if not (q.is_contiguous() and k.is_contiguous() and v.is_contiguous()):
        raise ValueError("flash_attention needs contiguous q/k/v")
    if sq == 0 or skv == 0 or b == 0:
        raise ValueError(f"empty attention: q {tuple(q.shape)}, k {tuple(k.shape)}")
    if _dispatched(q, k, v):
        return torch.ops.repro_torch.flash_attention(q, k, v, causal, int(q_offset))
    return _flash_launch(q, k, v, causal, int(q_offset))


@torch.library.custom_op("repro_torch::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool, q_offset: int) -> torch.Tensor:
    return _flash_launch(q, k, v, causal, q_offset)


def _flash_launch(q, k, v, causal: bool, q_offset: int) -> torch.Tensor:
    """The kernel's launch on checked CUDA tensors (``flash_attention``)."""
    b, sq, h, d = q.shape
    skv, kvh = k.shape[1], k.shape[2]
    o = torch.empty_like(q)
    if q.dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in (q, k, v, o)):
        raise ValueError("bf16 flash_attention needs q/k/v/o that start on a 16-byte boundary")
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


@_flash_op.register_fake
def _flash_fake(q, k, v, causal, q_offset):
    return torch.empty_like(q)


@register_flop_formula(torch.ops.repro_torch.flash_attention)
def _flash_flops(q_shape, k_shape, v_shape, causal, q_offset, *args, out_shape=None, **kwargs) -> int:
    b, sq, h, d = q_shape
    return int(costs.flash_cost(b, sq, k_shape[1], h, k_shape[2], d, 2, causal, q_offset)[1])


flash_attention.launches = 0


def _ssd_lib() -> ctypes.CDLL:
    lib = build.load("ssd_scan")
    fn = lib.repro_ssd_scan_fwd
    fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    size = lib.repro_ssd_scan_scratch_bytes
    size.argtypes = [ctypes.c_int] * 7
    size.restype = ctypes.c_size_t
    return lib


def _ssd_bwd_lib() -> ctypes.CDLL:
    lib = build.load("ssd_scan_bwd")
    fn = lib.repro_ssd_scan_bwd
    fn.argtypes = [ctypes.c_void_p] * 13 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    size = lib.repro_ssd_scan_bwd_scratch_bytes
    size.argtypes = [ctypes.c_int] * 7
    size.restype = ctypes.c_size_t
    return lib


def _check_ssd(xbar, log_da, bmat, cmat, chunk, state0, *grads) -> tuple[int, int, int, int, int]:
    """Shapes, dtypes and devices of a scan's inputs (and, for its gradient,
    of dy and d(final state)); returns (B, S, H, P, N)."""
    if xbar.ndim != 4 or log_da.ndim != 3 or bmat.ndim != 3 or cmat.ndim != 3:
        raise ValueError(
            f"expected xbar (B,S,H,P), log_da (B,S,H), bmat/cmat (B,S,N), got {tuple(xbar.shape)}, "
            f"{tuple(log_da.shape)}, {tuple(bmat.shape)}, {tuple(cmat.shape)}"
        )
    b, s, h, p = xbar.shape
    n = bmat.shape[-1]
    if tuple(log_da.shape) != (b, s, h) or tuple(bmat.shape) != (b, s, n) or cmat.shape != bmat.shape:
        raise ValueError(
            f"log_da {tuple(log_da.shape)}, bmat {tuple(bmat.shape)}, cmat {tuple(cmat.shape)} "
            f"do not match xbar {tuple(xbar.shape)}"
        )
    if state0 is not None and tuple(state0.shape) != (b, h, p, n):
        raise ValueError(f"state0 {tuple(state0.shape)} is not (B,H,P,N) = {(b, h, p, n)}")
    if not (xbar.dtype == bmat.dtype == cmat.dtype) or xbar.dtype not in _SSD_DTYPES:
        raise TypeError(
            f"ssd_scan takes fp32 or bf16 xbar/bmat/cmat of one dtype, got {xbar.dtype}/{bmat.dtype}/{cmat.dtype}"
        )
    if log_da.dtype != torch.float32 or (state0 is not None and state0.dtype != torch.float32):
        raise TypeError(f"ssd_scan takes fp32 log_da and state0, got {log_da.dtype}/"
                        f"{None if state0 is None else state0.dtype}")
    if grads:
        dy, dstate = grads
        if tuple(dy.shape) != (b, s, h, p) or dy.dtype != xbar.dtype:
            raise ValueError(f"dy {tuple(dy.shape)} {dy.dtype} is not xbar's {(b, s, h, p)} {xbar.dtype}")
        if dstate is not None and (tuple(dstate.shape) != (b, h, p, n) or dstate.dtype != torch.float32):
            raise ValueError(f"dstate {tuple(dstate.shape)} {dstate.dtype} is not fp32 (B,H,P,N) = {(b, h, p, n)}")
    if chunk <= 0:
        raise ValueError(f"chunk must be positive, got {chunk}")
    devices = {t.device for t in (xbar, log_da, bmat, cmat, state0, *grads) if t is not None}
    if len(devices) != 1:
        raise ValueError(f"ssd_scan inputs on different devices: {devices}")
    if xbar.device.type not in ("cpu", "cuda"):
        raise ValueError(f"ssd_scan runs on cpu or cuda, not {xbar.device}")
    if xbar.device.type == "cuda":
        if chunk not in _SSD_CHUNKS:
            raise ValueError(f"chunk {chunk} unsupported: the kernel takes {_SSD_CHUNKS}")
        if p > 128 or p % 8 or n > 128 or n % 8:
            raise ValueError(f"head dim {p} / state {n} unsupported: the kernel takes multiples of 8 up to 128")
        if b == 0 or s == 0 or h == 0:
            raise ValueError(f"empty scan: xbar {tuple(xbar.shape)}")
    return b, s, h, p, n


def ssd_scan(
    xbar: torch.Tensor,
    log_da: torch.Tensor,
    bmat: torch.Tensor,
    cmat: torch.Tensor,
    *,
    chunk: int = 128,
    state0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Chunked Mamba2 SSD scan: (y (B,S,H,P) in xbar's dtype, final state (B,H,P,N) fp32).

    xbar (B,S,H,P), log_da (B,S,H) fp32, bmat/cmat (B,S,N) of xbar's dtype
    (fp32 or bf16), optional fp32 ``state0`` (B,H,P,N); see
    ``ref.ssd_scan_ref``.  On the card P and N are multiples of 8 up to 128
    and ``chunk`` is 64 or 128.  bf16 runs Mamba2's chunk-parallel split on
    the tensor cores (three kernels; B * decay and the chunks' incoming
    states rounded to bf16, the intra-chunk weights as a bf16 pair hi + lo;
    ``csrc/ssd_scan.cu``); fp32 runs the CUDA-core kernels in true fp32.

    With grad mode on and an input that requires grad, the call goes through
    an autograd function whose forward is this one and whose backward is
    ``ssd_scan_bwd`` (on the card ``csrc/ssd_scan_bwd.cu``).
    """
    _check_ssd(xbar, log_da, bmat, cmat, chunk, state0)
    inputs = (xbar, log_da, bmat, cmat, state0)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in inputs):
        return _SSDScan.apply(xbar, log_da, bmat, cmat, state0, chunk)
    return _ssd_scan_fwd(xbar, log_da, bmat, cmat, chunk, state0)


def _ssd_scan_fwd(xbar, log_da, bmat, cmat, chunk, state0):
    if xbar.device.type == "cpu":
        return ssd_scan_ref(xbar, log_da, bmat, cmat, chunk=chunk, state0=state0)
    tensors = [xbar, log_da, bmat, cmat] + ([state0] if state0 is not None else [])
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssd_scan needs contiguous inputs")
    if _dispatched(*tensors):
        return torch.ops.repro_torch.ssd_scan_fwd(xbar, log_da, bmat, cmat, state0, chunk)
    return _ssd_fwd_launch(xbar, log_da, bmat, cmat, state0, chunk)


@torch.library.custom_op("repro_torch::ssd_scan_fwd", mutates_args=())
def _ssd_fwd_op(xbar: torch.Tensor, log_da: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
                state0: torch.Tensor | None, chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    return _ssd_fwd_launch(xbar, log_da, bmat, cmat, state0, chunk)


def _ssd_fwd_launch(xbar, log_da, bmat, cmat, state0, chunk: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The scan kernels' launch on checked CUDA tensors (``ssd_scan``)."""
    b, s, h, p = xbar.shape
    n = bmat.shape[-1]
    y = torch.empty_like(xbar)
    state = torch.empty((b, h, p, n), dtype=torch.float32, device=xbar.device)
    is_bf16 = int(xbar.dtype == torch.bfloat16)
    lib = _ssd_lib()
    # the kernels' scratch (C B^T of each chunk; for bf16 also the chunks'
    # local and incoming states), laid out by the C side; torch's allocations
    # start on a 256-byte boundary
    nbytes = lib.repro_ssd_scan_scratch_bytes(b, s, h, p, n, chunk, is_bf16)
    if nbytes == 0:
        raise ValueError(f"ssd_scan refuses xbar {tuple(xbar.shape)}, state {n}, chunk {chunk}")
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=xbar.device)
    with torch.cuda.device(xbar.device):
        err = lib.repro_ssd_scan_fwd(
            xbar.data_ptr(), log_da.data_ptr(), bmat.data_ptr(), cmat.data_ptr(), scratch.data_ptr(),
            None if state0 is None else state0.data_ptr(), y.data_ptr(), state.data_ptr(),
            b, s, h, p, n, chunk, is_bf16, torch.cuda.current_stream(xbar.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"ssd_scan kernel launch failed with cudaError_t {err}")
    ssd_scan.launches += 1
    return y, state


@_ssd_fwd_op.register_fake
def _ssd_fwd_fake(xbar, log_da, bmat, cmat, state0, chunk):
    b, _, h, p = xbar.shape
    return torch.empty_like(xbar), xbar.new_empty((b, h, p, bmat.shape[-1]), dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.ssd_scan_fwd)
def _ssd_fwd_flops(x_shape, la_shape, b_shape, c_shape, s0_shape, chunk, *args, out_shape=None, **kwargs) -> int:
    b, s, h, p = x_shape
    return int(costs.ssd_cost(b, s, h, p, b_shape[-1], 2, chunk, s0_shape is not None)[1])


ssd_scan.launches = 0


class _SSDScan(torch.autograd.Function):
    """``ssd_scan`` with its gradient: forward ``_ssd_scan_fwd``, backward ``ssd_scan_bwd``."""

    @staticmethod
    def forward(ctx, xbar, log_da, bmat, cmat, state0, chunk):
        ctx.chunk = chunk
        ctx.save_for_backward(xbar, log_da, bmat, cmat, state0)
        ctx.set_materialize_grads(False)
        return _ssd_scan_fwd(xbar, log_da, bmat, cmat, chunk, state0)

    @staticmethod
    def backward(ctx, dy, dstate):
        xbar, log_da, bmat, cmat, state0 = ctx.saved_tensors
        dy = torch.zeros_like(xbar) if dy is None else dy.contiguous()
        dstate = None if dstate is None else dstate.contiguous()
        dx, dla, db, dc, ds0 = ssd_scan_bwd(xbar, log_da, bmat, cmat, dy, dstate, chunk=ctx.chunk, state0=state0)
        return dx, dla, db, dc, ds0 if state0 is not None else None, None


def ssd_scan_bwd(
    xbar: torch.Tensor,
    log_da: torch.Tensor,
    bmat: torch.Tensor,
    cmat: torch.Tensor,
    dy: torch.Tensor,
    dstate: torch.Tensor | None,
    *,
    chunk: int = 128,
    state0: torch.Tensor | None = None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """The scan's gradient: (dxbar, dlog_da fp32, dB, dC, dstate0 fp32), see ``ref.ssd_scan_bwd_ref``.

    dy (B,S,H,P) in xbar's dtype, ``dstate`` the fp32 gradient of the final
    state (None: zero).  On the card ``csrc/ssd_scan_bwd.cu``, the
    chunk-parallel split, deterministic (no atomics, sums in a fixed order):
    bf16 on the tensor cores (five kernels; the causal triangle only; the
    state operands, the intra-chunk weights and the decayed rows rounded to
    bf16, every sum in fp32), fp32 in true fp32 on the CUDA cores (four
    kernels).  dxbar, dB and dC come back in the inputs' dtype.
    """
    b, s, h, p, n = _check_ssd(xbar, log_da, bmat, cmat, chunk, state0, dy, dstate)
    if xbar.device.type == "cpu":
        if dstate is None:
            dstate = torch.zeros((b, h, p, n), dtype=torch.float32)
        return ssd_scan_bwd_ref(xbar, log_da, bmat, cmat, dy, dstate, chunk=chunk, state0=state0)
    tensors = [t for t in (xbar, log_da, bmat, cmat, state0, dy, dstate) if t is not None]
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssd_scan_bwd needs contiguous inputs")
    if _dispatched(*tensors):
        return torch.ops.repro_torch.ssd_scan_bwd(xbar, log_da, bmat, cmat, state0, dy, dstate, chunk)
    return _ssd_bwd_launch(xbar, log_da, bmat, cmat, state0, dy, dstate, chunk)


@torch.library.custom_op("repro_torch::ssd_scan_bwd", mutates_args=())
def _ssd_bwd_op(xbar: torch.Tensor, log_da: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor,
                state0: torch.Tensor | None, dy: torch.Tensor, dstate: torch.Tensor | None,
                chunk: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    return _ssd_bwd_launch(xbar, log_da, bmat, cmat, state0, dy, dstate, chunk)


def _ssd_bwd_launch(xbar, log_da, bmat, cmat, state0, dy, dstate, chunk: int):
    """The backward kernels' launch on checked CUDA tensors (``ssd_scan_bwd``)."""
    b, s, h, p = xbar.shape
    n = bmat.shape[-1]
    dx, db, dc = torch.empty_like(xbar), torch.empty_like(bmat), torch.empty_like(cmat)
    dla = torch.empty_like(log_da)
    ds0 = torch.empty((b, h, p, n), dtype=torch.float32, device=xbar.device)
    is_bf16 = int(xbar.dtype == torch.bfloat16)
    lib = _ssd_bwd_lib()
    nbytes = lib.repro_ssd_scan_bwd_scratch_bytes(b, s, h, p, n, chunk, is_bf16)
    if nbytes == 0:
        raise ValueError(f"ssd_scan_bwd refuses xbar {tuple(xbar.shape)}, state {n}, chunk {chunk}")
    scratch = torch.empty(nbytes, dtype=torch.uint8, device=xbar.device)
    with torch.cuda.device(xbar.device):
        err = lib.repro_ssd_scan_bwd(
            xbar.data_ptr(), log_da.data_ptr(), bmat.data_ptr(), cmat.data_ptr(),
            None if state0 is None else state0.data_ptr(), dy.data_ptr(),
            None if dstate is None else dstate.data_ptr(), scratch.data_ptr(), dx.data_ptr(),
            dla.data_ptr(), db.data_ptr(), dc.data_ptr(), ds0.data_ptr(),
            b, s, h, p, n, chunk, is_bf16, torch.cuda.current_stream(xbar.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"ssd_scan_bwd kernel launch failed with cudaError_t {err}")
    ssd_scan_bwd.launches += 1
    return dx, dla, db, dc, ds0


@_ssd_bwd_op.register_fake
def _ssd_bwd_fake(xbar, log_da, bmat, cmat, state0, dy, dstate, chunk):
    b, _, h, p = xbar.shape
    ds0 = xbar.new_empty((b, h, p, bmat.shape[-1]), dtype=torch.float32)
    return torch.empty_like(xbar), torch.empty_like(log_da), torch.empty_like(bmat), torch.empty_like(cmat), ds0


@register_flop_formula(torch.ops.repro_torch.ssd_scan_bwd)
def _ssd_bwd_flops(x_shape, la_shape, b_shape, c_shape, s0_shape, dy_shape, ds_shape, chunk, *args,
                   out_shape=None, **kwargs) -> int:
    b, s, h, p = x_shape
    return int(costs.ssd_bwd_cost(b, s, h, p, b_shape[-1], 2, chunk, s0_shape is not None,
                                  ds_shape is not None)[1])


def _scan_scratch(lib_fn, xbar, bmat, chunk) -> int:
    b, s, h, p = xbar.shape
    return int(lib_fn(b, s, h, p, bmat.shape[-1], chunk, int(xbar.dtype == torch.bfloat16)))


#: op -> bytes of device scratch its kernel allocates for these arguments
#: (the C side's own layout; reads the built library, on the card)
SCRATCH_BYTES = {
    torch.ops.repro_torch.ssd_scan_fwd.default:
        lambda xbar, log_da, bmat, cmat, state0, chunk: _scan_scratch(
            _ssd_lib().repro_ssd_scan_scratch_bytes, xbar, bmat, chunk),
    torch.ops.repro_torch.ssd_scan_bwd.default:
        lambda xbar, log_da, bmat, cmat, state0, dy, dstate, chunk: _scan_scratch(
            _ssd_bwd_lib().repro_ssd_scan_bwd_scratch_bytes, xbar, bmat, chunk),
}


ssd_scan_bwd.launches = 0


# ------------------------------------------------------------ the Mamba2 mixer's chain

def _mixer_lib() -> ctypes.CDLL:
    lib = build.load("ssm_mixer")
    fn = lib.repro_ssm_conv_gate_in
    fn.argtypes = [ctypes.c_void_p] * 23 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.repro_ssm_gate_norm
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3 + [ctypes.c_float, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def _check_cuda_operands(name: str, bf16: dict, fp32: dict) -> None:
    """A mixer kernel's CUDA operands: one device, bf16 / fp32 as named, contiguous."""
    tensors = {**bf16, **{k: v for k, v in fp32.items() if v is not None}}
    devices = {t.device for t in tensors.values()}
    if len(devices) != 1:
        raise ValueError(f"{name} inputs on different devices: {devices}")
    for k, t in bf16.items():
        if t.dtype != torch.bfloat16:
            raise TypeError(f"{name} takes bf16 {k} on the card, got {t.dtype}")
    for k, t in fp32.items():
        if t is not None and t.dtype != torch.float32:
            raise TypeError(f"{name} takes fp32 {k} on the card, got {t.dtype}")
    for k, t in tensors.items():
        if not t.is_contiguous():
            raise ValueError(f"{name} needs a contiguous {k}")


def _check_aligned(name: str, tensors) -> None:
    """The kernels move 16 bytes at a time: every operand starts on a 16-byte boundary."""
    if any(t is not None and t.data_ptr() % 16 for t in tensors):
        raise ValueError(f"{name} needs operands that start on a 16-byte boundary")


def ssm_conv_gate_in(
    xs: torch.Tensor,
    bmat: torch.Tensor,
    cmat: torch.Tensor,
    dt: torch.Tensor,
    w_conv_x: torch.Tensor,
    b_conv_x: torch.Tensor,
    w_conv_b: torch.Tensor,
    b_conv_b: torch.Tensor,
    w_conv_c: torch.Tensor,
    b_conv_c: torch.Tensor,
    dt_bias: torch.Tensor,
    a_log: torch.Tensor,
    conv_x: torch.Tensor | None = None,
    conv_b: torch.Tensor | None = None,
    conv_c: torch.Tensor | None = None,
) -> tuple[torch.Tensor, ...]:
    """The Mamba2 mixer's chain before the scan: the causal depthwise conv and
    silu of x, B and C, softplus of dt, xbar and log_da, and the new conv
    states; see ``ref.ssm_conv_gate_in_ref`` for the arguments and outputs.

    On the card ``csrc/ssm_mixer.cu``'s front kernel, one pass over its
    inputs and outputs, rounding to bf16 at each step where the plain chain
    does: bf16 streams, conv weights and biases, fp32 ``dt_bias``, ``a_log``
    and conv states (the cache's), the head dim and N multiples of 8, 4 taps
    (Mamba2's).  Not differentiable: the model takes it only where autograd
    would not record the chain.
    """
    if xs.ndim != 3 or bmat.ndim != 3 or dt.ndim != 3 or w_conv_x.ndim != 2:
        raise ValueError(f"expected xs, bmat, cmat, dt (B,S,.) and conv weights (K,.), got {tuple(xs.shape)}, "
                         f"{tuple(bmat.shape)}, {tuple(dt.shape)}, {tuple(w_conv_x.shape)}")
    b, s, ci = xs.shape
    n, h, k = bmat.shape[-1], dt.shape[-1], w_conv_x.shape[0]
    if (tuple(bmat.shape) != (b, s, n) or tuple(cmat.shape) != (b, s, n) or tuple(dt.shape) != (b, s, h)
            or h == 0 or ci % h or tuple(dt_bias.shape) != (h,) or tuple(a_log.shape) != (h,)):
        raise ValueError(f"bmat {tuple(bmat.shape)}, cmat {tuple(cmat.shape)}, dt {tuple(dt.shape)}, dt_bias "
                         f"{tuple(dt_bias.shape)}, a_log {tuple(a_log.shape)} do not match xs {tuple(xs.shape)}")
    streams = {"x": (w_conv_x, b_conv_x, conv_x, ci), "b": (w_conv_b, b_conv_b, conv_b, n),
               "c": (w_conv_c, b_conv_c, conv_c, n)}
    for name, (w, bias, state, width) in streams.items():
        if tuple(w.shape) != (k, width) or tuple(bias.shape) != (width,):
            raise ValueError(f"conv weight / bias of {name} {tuple(w.shape)} / {tuple(bias.shape)} are not "
                             f"({k}, {width}) / ({width},)")
        if state is not None and tuple(state.shape) != (b, k - 1, width):
            raise ValueError(f"conv state of {name} {tuple(state.shape)} is not {(b, k - 1, width)}")
    args = (xs, bmat, cmat, dt, w_conv_x, b_conv_x, w_conv_b, b_conv_b, w_conv_c, b_conv_c, dt_bias, a_log,
            conv_x, conv_b, conv_c)
    if xs.device.type == "cpu":
        return ssm_conv_gate_in_ref(*args)
    if xs.device.type != "cuda":
        raise ValueError(f"ssm_conv_gate_in runs on cpu or cuda, not {xs.device}")
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in args):
        raise RuntimeError("ssm_conv_gate_in has no gradient: the model runs the plain chain where autograd records")
    if ci % 8 or (ci // h) % 8 or n % 8 or k != 4:
        raise ValueError(f"ssm_conv_gate_in takes head dims and state widths that are multiples of 8 and "
                         f"4 taps, got xs {tuple(xs.shape)} over {h} heads, state {n}, {k} taps")
    if b == 0 or s == 0:
        raise ValueError(f"empty ssm_conv_gate_in: xs {tuple(xs.shape)}")
    _check_cuda_operands(
        "ssm_conv_gate_in",
        {"xs": xs, "bmat": bmat, "cmat": cmat, "dt": dt, "w_conv_x": w_conv_x, "b_conv_x": b_conv_x,
         "w_conv_b": w_conv_b, "b_conv_b": b_conv_b, "w_conv_c": w_conv_c, "b_conv_c": b_conv_c},
        {"dt_bias": dt_bias, "a_log": a_log, "conv_x": conv_x, "conv_b": conv_b, "conv_c": conv_c})
    if _dispatched(*(t for t in args if t is not None)):
        return torch.ops.repro_torch.ssm_conv_gate_in(*args)
    return _conv_gate_in_launch(*args)


@torch.library.custom_op("repro_torch::ssm_conv_gate_in", mutates_args=())
def _conv_gate_in_op(
    xs: torch.Tensor, bmat: torch.Tensor, cmat: torch.Tensor, dt: torch.Tensor, w_conv_x: torch.Tensor,
    b_conv_x: torch.Tensor, w_conv_b: torch.Tensor, b_conv_b: torch.Tensor, w_conv_c: torch.Tensor,
    b_conv_c: torch.Tensor, dt_bias: torch.Tensor, a_log: torch.Tensor, conv_x: torch.Tensor | None,
    conv_b: torch.Tensor | None, conv_c: torch.Tensor | None,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
           torch.Tensor]:
    return _conv_gate_in_launch(xs, bmat, cmat, dt, w_conv_x, b_conv_x, w_conv_b, b_conv_b, w_conv_c, b_conv_c,
                                dt_bias, a_log, conv_x, conv_b, conv_c)


def _conv_gate_in_empty(xs, bmat, dt, k: int) -> tuple[torch.Tensor, ...]:
    """``ssm_conv_gate_in``'s outputs, allocated: xs, bmat, cmat, xbar, log_da and three conv states."""
    b, s, ci = xs.shape
    h, n = dt.shape[-1], bmat.shape[-1]
    return (torch.empty_like(xs), torch.empty_like(bmat), torch.empty_like(bmat),
            xs.new_empty((b, s, h, ci // h)), xs.new_empty((b, s, h), dtype=torch.float32),
            xs.new_empty((b, k - 1, ci)), bmat.new_empty((b, k - 1, n)), bmat.new_empty((b, k - 1, n)))


def _conv_gate_in_launch(xs, bmat, cmat, dt, w_conv_x, b_conv_x, w_conv_b, b_conv_b, w_conv_c, b_conv_c,
                         dt_bias, a_log, conv_x, conv_b, conv_c) -> tuple[torch.Tensor, ...]:
    """The front kernel's launch on checked CUDA tensors (``ssm_conv_gate_in``)."""
    b, s, ci = xs.shape
    n, h, k = bmat.shape[-1], dt.shape[-1], w_conv_x.shape[0]
    ins = (xs, bmat, cmat, dt, w_conv_x, b_conv_x, w_conv_b, b_conv_b, w_conv_c, b_conv_c, dt_bias, a_log,
           conv_x, conv_b, conv_c)
    outs = _conv_gate_in_empty(xs, bmat, dt, k)
    _check_aligned("ssm_conv_gate_in", ins[:10] + ins[12:])  # dt_bias and a_log are read one by one
    lib = _mixer_lib()
    with torch.cuda.device(xs.device):
        err = lib.repro_ssm_conv_gate_in(
            *(None if t is None else t.data_ptr() for t in ins), *(t.data_ptr() for t in outs),
            b, s, ci, n, h, k, torch.cuda.current_stream(xs.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"ssm_conv_gate_in kernel launch failed with cudaError_t {err}")
    ssm_conv_gate_in.launches += 1
    return outs


@_conv_gate_in_op.register_fake
def _conv_gate_in_fake(xs, bmat, cmat, dt, w_conv_x, b_conv_x, w_conv_b, b_conv_b, w_conv_c, b_conv_c, dt_bias,
                       a_log, conv_x, conv_b, conv_c):
    return _conv_gate_in_empty(xs, bmat, dt, w_conv_x.shape[0])


ssm_conv_gate_in.launches = 0


def ssm_gate_norm(
    y: torch.Tensor,
    xs: torch.Tensor,
    z: torch.Tensor,
    d_skip: torch.Tensor,
    scale: torch.Tensor | None = None,
    eps: float = 1e-5,
) -> torch.Tensor:
    """The Mamba2 mixer's chain after the scan: (y + xs * D) * silu(z), then
    the RMS norm over the inner width by ``scale`` when it is given; see
    ``ref.ssm_gate_norm_ref``.  y (B,S,H,P), xs and z (B,S,H*P), d_skip (H,).

    On the card ``csrc/ssm_mixer.cu``'s back kernel, one block per token row:
    bf16 y, xs and z, fp32 d_skip and scale, P a multiple of 8, the width at
    most 8,192.  It rounds to bf16 where the plain chain does and takes the
    norm's sum of squares in fp32 in its own order.  Not differentiable.
    """
    if y.ndim != 4:
        raise ValueError(f"expected y (B,S,H,P), got {tuple(y.shape)}")
    b, s, h, p = y.shape
    if (tuple(xs.shape) != (b, s, h * p) or tuple(z.shape) != (b, s, h * p) or tuple(d_skip.shape) != (h,)
            or (scale is not None and tuple(scale.shape) != (h * p,))):
        raise ValueError(f"xs {tuple(xs.shape)}, z {tuple(z.shape)}, d_skip {tuple(d_skip.shape)}, scale "
                         f"{None if scale is None else tuple(scale.shape)} do not match y {tuple(y.shape)}")
    if y.device.type == "cpu":
        return ssm_gate_norm_ref(y, xs, z, d_skip, scale, eps)
    if y.device.type != "cuda":
        raise ValueError(f"ssm_gate_norm runs on cpu or cuda, not {y.device}")
    args = (y, xs, z, d_skip, scale)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in args):
        raise RuntimeError("ssm_gate_norm has no gradient: the model runs the plain chain where autograd records")
    if p % 8 or h * p > 8192:
        raise ValueError(f"ssm_gate_norm takes head dims that are multiples of 8 and widths up to 8,192, "
                         f"got y {tuple(y.shape)}")
    if b == 0 or s == 0 or h == 0:
        raise ValueError(f"empty ssm_gate_norm: y {tuple(y.shape)}")
    _check_cuda_operands("ssm_gate_norm", {"y": y, "xs": xs, "z": z}, {"d_skip": d_skip, "scale": scale})
    if _dispatched(*(t for t in args if t is not None)):
        return torch.ops.repro_torch.ssm_gate_norm(y, xs, z, d_skip, scale, float(eps))
    return _gate_norm_launch(y, xs, z, d_skip, scale, float(eps))


@torch.library.custom_op("repro_torch::ssm_gate_norm", mutates_args=())
def _gate_norm_op(y: torch.Tensor, xs: torch.Tensor, z: torch.Tensor, d_skip: torch.Tensor,
                  scale: torch.Tensor | None, eps: float) -> torch.Tensor:
    return _gate_norm_launch(y, xs, z, d_skip, scale, eps)


def _gate_norm_launch(y, xs, z, d_skip, scale, eps: float) -> torch.Tensor:
    """The back kernel's launch on checked CUDA tensors (``ssm_gate_norm``)."""
    b, s, h, p = y.shape
    out = torch.empty_like(xs)
    _check_aligned("ssm_gate_norm", (y, xs, z, scale))
    lib = _mixer_lib()
    with torch.cuda.device(y.device):
        err = lib.repro_ssm_gate_norm(
            y.data_ptr(), xs.data_ptr(), z.data_ptr(), d_skip.data_ptr(),
            None if scale is None else scale.data_ptr(), out.data_ptr(), b * s, h * p, h, eps,
            torch.cuda.current_stream(y.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"ssm_gate_norm kernel launch failed with cudaError_t {err}")
    ssm_gate_norm.launches += 1
    return out


@_gate_norm_op.register_fake
def _gate_norm_fake(y, xs, z, d_skip, scale, eps):
    return torch.empty_like(xs)


ssm_gate_norm.launches = 0


# ------------------------------------------------------------ the dropless MoE's grouped products

#: up to this many tokens a call takes the decode entry point (tiles of 16 rows, a block per
#: (column block, expert), empty experts skipped); above it the prefill's (tiles of 128 rows)
MOE_DECODE_TOKENS = 64


def _moe_lib() -> ctypes.CDLL:
    lib = build.load("moe_grouped")
    fn = lib.repro_moe_grouped_mm
    fn.argtypes = [ctypes.c_void_p] * 9 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def moe_grouped_mm(
    x: torch.Tensor,
    w_in: torch.Tensor,
    w_gate: torch.Tensor,
    w_out: torch.Tensor,
    src: torch.Tensor,
    dst: torch.Tensor,
    offsets: torch.Tensor,
) -> torch.Tensor:
    """The experts' SwiGLU products over routed entries sorted by expert: y (R, D) in entry order;
    see ``ref.moe_grouped_mm_ref`` for the arguments.  x (T, D), the weights (E, D, F) and (E, F, D),
    src and dst (R,) and offsets (E+1,) int32, all on one device.

    On the card ``csrc/moe_grouped.cu``: two launches (gate and up with
    silu, then down) of the decode entry point when T is at most
    ``MOE_DECODE_TOKENS``, else of the prefill's, under grids that do not
    depend on the routing, reading the offsets on the device only (a CUDA
    graph captures it); bf16, D a multiple of 128 and F of 64.  Not
    differentiable: the model takes the plain version where autograd records.
    """
    if x.ndim != 2 or w_in.ndim != 3 or src.ndim != 1:
        raise ValueError(f"expected x (T,D), w_in (E,D,F), src (R,), got {tuple(x.shape)}, {tuple(w_in.shape)}, "
                         f"{tuple(src.shape)}")
    t, d = x.shape
    e, f = w_in.shape[0], w_in.shape[2]
    r = src.shape[0]
    if (tuple(w_in.shape) != (e, d, f) or tuple(w_gate.shape) != (e, d, f) or tuple(w_out.shape) != (e, f, d)
            or tuple(dst.shape) != (r,) or tuple(offsets.shape) != (e + 1,)):
        raise ValueError(f"w_in {tuple(w_in.shape)}, w_gate {tuple(w_gate.shape)}, w_out {tuple(w_out.shape)}, dst "
                         f"{tuple(dst.shape)}, offsets {tuple(offsets.shape)} do not match x {tuple(x.shape)} and "
                         f"{r} rows")
    args = (x, w_in, w_gate, w_out, src, dst, offsets)
    devices = {a.device for a in args}
    if len(devices) != 1:
        raise ValueError(f"moe_grouped_mm inputs on different devices: {devices}")
    if x.device.type == "cpu":
        return moe_grouped_mm_ref(*args)
    if x.device.type != "cuda":
        raise ValueError(f"moe_grouped_mm runs on cpu or cuda, not {x.device}")
    if torch.is_grad_enabled() and any(a.requires_grad for a in args[:4]):
        raise RuntimeError("moe_grouped_mm has no gradient: the model runs the plain version where autograd records")
    if d % 128 or f % 64 or t == 0 or r == 0:
        raise ValueError(f"moe_grouped_mm takes D a multiple of 128 and F of 64, and some rows: x {tuple(x.shape)}, "
                         f"F {f}, {r} rows")
    _check_cuda_operands("moe_grouped_mm", {"x": x, "w_in": w_in, "w_gate": w_gate, "w_out": w_out}, {})
    for name, a in (("src", src), ("dst", dst), ("offsets", offsets)):
        if a.dtype != torch.int32 or not a.is_contiguous():
            raise TypeError(f"moe_grouped_mm takes a contiguous int32 {name}, got {a.dtype}")
    return _moe_launch(*args)


def _moe_launch(x, w_in, w_gate, w_out, src, dst, offsets) -> torch.Tensor:
    """The grouped kernels' launches on checked CUDA tensors (``moe_grouped_mm``)."""
    t, d = x.shape
    e, f = w_in.shape[0], w_in.shape[2]
    r = src.shape[0]
    h = x.new_empty((r, f))  # scratch: phase 1's gated rows, phase 2's input
    y = x.new_empty((r, d))
    _check_aligned("moe_grouped_mm", (x, w_in, w_gate, w_out, h, y))
    lib = _moe_lib()
    with torch.cuda.device(x.device):
        err = lib.repro_moe_grouped_mm(
            x.data_ptr(), w_in.data_ptr(), w_gate.data_ptr(), w_out.data_ptr(), src.data_ptr(), dst.data_ptr(),
            offsets.data_ptr(), h.data_ptr(), y.data_ptr(), t, r, e, d, f, int(t <= MOE_DECODE_TOKENS),
            torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"moe_grouped_mm kernel launch failed with cudaError_t {err}")
    moe_grouped_mm.launches += 1
    return y


moe_grouped_mm.launches = 0
