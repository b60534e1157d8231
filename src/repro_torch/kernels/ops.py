"""Wrappers around the port's kernels (ported from ``repro.kernels.ops``).

On a CPU tensor a wrapper runs its kernel's plain PyTorch version
(``ref.py``); that is the only reason it takes the plain version.  On a CUDA
tensor it checks device, dtype, shape and contiguity, allocates the output,
launches the hand-written kernel on PyTorch's current stream and raises if
the launch is refused.  There is no fallback from the kernel to the plain
version.  Each wrapper counts its kernel's launches in ``<wrapper>.launches``.
A CUDA-graph replay (``generate``'s decode step) goes through no wrapper, so
no counter counts it; the decode step launches neither kernel anyway (one
query takes ``full_attention``, and mamba2 decodes by its recurrence).

Each launch is also a ``torch.library.custom_op`` (``repro_torch::flash_attention``,
``repro_torch::ssd_scan_fwd``, ``repro_torch::ssd_scan_bwd``) whose body is
the ctypes launch above, so the dispatcher can trace it: each has a fake
implementation (shapes only; a fake tensor computes nothing and reaches no
plain version), a FLOP formula from ``costs.py`` (``torch.utils.flop_counter``
and the dry run count the work the bounds count) and ``SCRATCH_BYTES``, the
device scratch its kernel allocates beside its outputs.  A wrapper goes
through the op only when something watches the dispatcher (``_dispatched``:
a dispatch mode such as fake tensors or FLOP counting, or a tensor subclass
such as a DTensor); plain CUDA tensors call the launch directly, as before
the ops existed, and skip the op's Python dispatch.  Under sharding
rules the models call them through ``distributed.local_call`` on each
rank's heads (and batch), so the ops themselves see local tensors.

``ops.py`` of the reference pads head dims and state widths to 128 lanes and
sequences to block or chunk multiples for the TPU; the CUDA kernels mask the
ragged edge themselves, so nothing is padded here.
"""

from __future__ import annotations

import ctypes

import torch

from torch.utils.flop_counter import register_flop_formula

from repro_torch.kernels import build, costs
from repro_torch.kernels.ref import flash_attention_ref, ssd_scan_bwd_ref, ssd_scan_ref

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
