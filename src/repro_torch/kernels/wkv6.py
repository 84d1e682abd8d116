"""RWKV-6 WKV recurrence: the hand-written CUDA kernel and its wrapper.

Replaces the Pallas kernel ``src/repro/kernels/rwkv6_scan.py:
_wkv6_kernel``.  The CUDA source is ``csrc/wkv6.cu``: a prefill runs the
chunked form on the tensor cores in split TF32, a block of 16 warps per
(batch, head, ``COLUMNS[d]`` value columns of the d x d state) walking
chunks of ``CHUNK[d]`` steps (a chunk whose decays or factors leave
float32's range is evaluated step by step), producer warps preparing each
next chunk while consumer warps hold the state in registers; a decode step
(S = 1) is a kernel of its own, one pass over the state.  Both are bound
by bytes (see the source's note).

The wrapper takes the model's layout: r, k, v (B, S, H, d), float32 or
bfloat16 alike, logw (B, S, H, d) float32, as strided views whose last
dimension is contiguous (a view whose rows a 16-byte copy cannot read is
copied first, ``flash_attention.aligned_rows``); u (H, d) float32; an
optional float32 starting state s0 (B, H, d, d).  It returns
``(y, s_last)``: y a dense (B, S, H, d) tensor in r's dtype, s_last a new
dense float32 (B, H, d, d) tensor (s0 is never written: the serving code
reads caches again after a step).  A decode step (S = 1) is one launch
from s0.  A CUDA tensor launches the kernel (or the call raises); a CPU
tensor runs the plain version :func:`repro_torch.kernels.ref.ref_wkv6`.
``wkv6.launches`` counts launches, and only those.

The backward is ``csrc/wkv6_bwd.cu`` (:func:`wkv6_bwd`, through the
autograd Function :class:`WKV6` where an input requires grad): the
forward's chunked form transposed, on the tensor cores in split TF32, one
block of 8 warps per (batch, head) over chunks of ``BWD_CHUNK[d]`` steps.
A walk forward writes the state entering each chunk to a workspace
(:func:`bwd_workspace_bytes`); a walk back, last chunk first, keeps dS in
registers, takes dr, dk and dv from the chunk's products and sums dlogw
directly from them (no difference of sums), and walks a chunk past the
forward's guards step by step; a second kernel adds du's partials over the
batch in batch order.  It is bound by bytes at rwkv6-7b's training shape
(``roofline.kernel_costs.wkv6_bwd_cost`` counts its products on the TF32
rate).  ``wkv6_bwd.launches`` counts its calls (two kernels each).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch._subclasses.fake_tensor import is_fake

from ..roofline import kernel_costs
from ._build import load_library
from .flash_attention import aligned_rows
from .ref import ref_wkv6

DTYPES = (torch.float32, torch.bfloat16)
HEAD_DIMS = (16, 32, 64, 128)
#: steps per chunk of the prefill kernel, by head dim
CHUNK = {16: 32, 32: 32, 64: 32, 128: 16}
#: value columns a prefill block owns, by head dim (rwkv6-7b's 64 heads of
#: 64 at batch 1 make 128 blocks, one an SM)
COLUMNS = {16: 16, 32: 32, 64: 32, 128: 16}
#: value columns of a decode block
STEP_COLS = 16
#: steps a chunk of the backward's walks, by head dim (the forward's
#: CHUNK: 32 steps at the -5 clamp stay within the recentring's range)
BWD_CHUNK = {16: 32, 32: 32, 64: 32, 128: 16}
#: a chunk with a channel whose summed logw is below this is evaluated
#: step by step: exp(-TOTAL_MIN / 2) stays within float32
TOTAL_MIN = -165.0
#: ... as is a chunk with a recentred factor q_in or k_in past this (its
#: TF32 parts stay finite)
FACTOR_MAX = 1e38

_lib: Optional[ctypes.CDLL] = None
_build_log = ""
_bwd_lib: Optional[ctypes.CDLL] = None
_bwd_build_log = ""


def build() -> str:
    """Compile ``csrc/wkv6.cu`` (once per source and flags) and load it.
    Returns ``nvcc``'s ``-Xptxas -v`` report."""
    global _lib, _build_log
    if _lib is None:
        _lib, _build_log = load_library("wkv6.cu", {
            "wkv6_launch": [ctypes.c_int] * 2 + [ctypes.c_void_p] * 8
                + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2,
        })
    return _build_log


def build_bwd() -> str:
    """Compile ``csrc/wkv6_bwd.cu`` (once per source and flags) and load
    it.  Returns ``nvcc``'s ``-Xptxas -v`` report."""
    global _bwd_lib, _bwd_build_log
    if _bwd_lib is None:
        _bwd_lib, _bwd_build_log = load_library("wkv6_bwd.cu", {
            "wkv6_bwd_launch": [ctypes.c_int] * 2 + [ctypes.c_void_p] * 15
                + [ctypes.c_int] * 3 + [ctypes.c_void_p] * 2,
        })
    return _bwd_build_log


def bwd_plan(seq: int, head_dim: int) -> Tuple[int, int]:
    """(steps a chunk, chunks) of a backward launch: one block per (batch,
    head), a whole head, walking ``ceil(seq / BWD_CHUNK[head_dim])``
    chunks forward (but the last) and then back."""
    chunk = BWD_CHUNK[head_dim]
    return chunk, -(-seq // chunk)


def bwd_workspace_bytes(B: int, S: int, H: int, D: int) -> int:
    """The backward's float32 workspace: the state entering each chunk of
    each (batch, head), d x d, and du's partials, (B, H, d)."""
    _, n_chunks = bwd_plan(S, D)
    return 4 * (n_chunks * B * H * D * D + B * H * D)


def plan(seq: int, head_dim: int) -> Tuple[int, int]:
    """(steps a chunk, value columns a block) of a launch, as the kernel
    takes them: a decode step (S = 1) is one step over blocks of
    ``STEP_COLS`` columns, a prefill chunks of ``CHUNK[head_dim]`` steps
    over blocks of ``COLUMNS[head_dim]`` columns."""
    if seq == 1:
        return 1, STEP_COLS
    return CHUNK[head_dim], COLUMNS[head_dim]


def _check(r, k, v, logw, u, s0) -> None:
    if r.dim() != 4 or not (r.shape == k.shape == v.shape == logw.shape):
        raise ValueError(f"r, k, v and logw must all be (B, S, H, d): "
                         f"{[tuple(t.shape) for t in (r, k, v, logw)]}")
    B, _, H, D = r.shape
    if not (r.dtype == k.dtype == v.dtype) or r.dtype not in DTYPES:
        raise TypeError(f"r, k and v must share float32 or bfloat16: "
                        f"{r.dtype}, {k.dtype}, {v.dtype}")
    if logw.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError(f"logw and u must be float32: {logw.dtype}, "
                        f"{u.dtype}")
    if u.shape != (H, D):
        raise ValueError(f"u must be (H, d) = {(H, D)}: {tuple(u.shape)}")
    tensors = [r, k, v, logw, u]
    if s0 is not None:
        if s0.shape != (B, H, D, D):
            raise ValueError(f"s0 must be (B, H, d, d) = {(B, H, D, D)}: "
                             f"{tuple(s0.shape)}")
        if s0.dtype != torch.float32:
            raise TypeError(f"s0 must be float32: {s0.dtype}")
        tensors.append(s0)
    if len({t.device for t in tensors}) != 1:
        raise ValueError(f"tensors on different devices: "
                         f"{[str(t.device) for t in tensors]}")


def _launch(r, k, v, logw, u, s0) -> Tuple[torch.Tensor, torch.Tensor]:
    """One counted launch."""
    B, S, H, D = r.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"the wkv6 kernel takes head dims {HEAD_DIMS}: {D}")
    r, k, v, logw = (aligned_rows(t) for t in (r, k, v, logw))
    u = u.contiguous()
    if s0 is not None and (s0.stride(-1) != 1 or s0.stride(-2) != D
                           or s0.data_ptr() % 16 or s0.stride(0) % 4
                           or s0.stride(1) % 4):
        s0 = s0.clone(memory_format=torch.contiguous_format)
    y = torch.empty((B, S, H, D), dtype=r.dtype, device=r.device)
    s_last = torch.empty((B, H, D, D), dtype=torch.float32, device=r.device)
    build()
    st = [x for t in (r, k, v, logw) for x in t.stride()[:3]]
    st += list(s0.stride()[:2]) if s0 is not None else [0, 0]
    strides = (ctypes.c_longlong * 14)(*st)
    with torch.cuda.device(r.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib.wkv6_launch(
            int(r.dtype == torch.bfloat16), D, r.data_ptr(), k.data_ptr(),
            v.data_ptr(), logw.data_ptr(), u.data_ptr(),
            s0.data_ptr() if s0 is not None else None, y.data_ptr(),
            s_last.data_ptr(), B, S, H, strides, stream)
    if err == -2:
        raise RuntimeError("wkv6: the driver refused the prefill's tensor "
                           "maps (cuTensorMapEncodeTiled)")
    if err != 0:
        raise RuntimeError(f"wkv6 kernel launch failed: CUDA error {err}")
    wkv6.launches += 1
    return y, s_last


def _launch_bwd(r, k, v, logw, u, s0, dy, ds_last):
    """One counted call of the backward (two kernels)."""
    B, S, H, D = r.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"the wkv6 kernel takes head dims {HEAD_DIMS}: {D}")
    r, k, v, logw, dy = (aligned_rows(t) for t in (r, k, v, logw, dy))
    u = u.contiguous()
    s0, ds_last = (None if t is None else t.contiguous()
                   for t in (s0, ds_last))
    dev = r.device
    dr, dk, dv = (torch.empty((B, S, H, D), dtype=r.dtype, device=dev)
                  for _ in range(3))
    dlogw = torch.empty((B, S, H, D), dtype=torch.float32, device=dev)
    du = torch.empty((H, D), dtype=torch.float32, device=dev)
    ds0 = (torch.empty((B, H, D, D), dtype=torch.float32, device=dev)
           if s0 is not None else None)
    build_bwd()
    nbytes = bwd_workspace_bytes(B, S, H, D)
    ws = torch.empty(nbytes // 4, dtype=torch.float32, device=dev)
    strides = (ctypes.c_longlong * 15)(
        *[x for t in (r, k, v, logw, dy) for x in t.stride()[:3]])

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bwd_lib.wkv6_bwd_launch(
            int(r.dtype == torch.bfloat16), D, ptr(r), ptr(k), ptr(v),
            ptr(logw), ptr(u), ptr(s0), ptr(dy), ptr(ds_last), ptr(dr),
            ptr(dk), ptr(dv), ptr(dlogw), ptr(du), ptr(ds0), ptr(ws), B, S,
            H, strides, stream)
    if err == -2:
        raise RuntimeError("wkv6_bwd: cuTensorMapEncodeTiled refused the "
                           "tensor maps")
    if err != 0:
        raise RuntimeError(f"wkv6_bwd kernel launch failed: CUDA error "
                           f"{err}")
    wkv6_bwd.launches += 1
    return dr, dk, dv, dlogw, du, ds0


def wkv6_bwd(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
             logw: torch.Tensor, u: torch.Tensor, s0: Optional[torch.Tensor],
             dy: torch.Tensor, ds_last: Optional[torch.Tensor] = None):
    """The gradients ``(dr, dk, dv, dlogw, du, ds0)`` of :func:`wkv6` at
    (r, k, v, logw, u, s0), given y's cotangent ``dy`` (r's shape and
    dtype) and s_last's ``ds_last`` (float32 (B, H, d, d), or None: s_last
    unused).  dr, dk and dv come in r's dtype, dlogw and du float32, ds0
    float32 (None where s0 is None).  CUDA tensors run the hand-written
    kernel; CPU tensors autograd through the plain version; fake tensors
    return fake gradients and add the kernel's operations and bytes to
    ``roofline.kernel_costs.COUNTS``.  Any other device raises."""
    _check(r, k, v, logw, u, s0)
    if dy.shape != r.shape or dy.dtype != r.dtype:
        raise ValueError(f"dy must be r's shape and dtype: {tuple(dy.shape)}"
                         f" {dy.dtype}")
    B, S, H, D = r.shape
    if ds_last is not None and (ds_last.shape != (B, H, D, D)
                                or ds_last.dtype != torch.float32):
        raise ValueError(f"ds_last must be float32 (B, H, d, d): "
                         f"{tuple(ds_last.shape)} {ds_last.dtype}")
    fake = is_fake(r)
    if r.device.type == "cpu" and not fake:
        with torch.enable_grad():
            leaves = [t.detach().requires_grad_() for t in (r, k, v, logw, u)]
            if s0 is not None:
                leaves.append(s0.detach().requires_grad_())
            y, s_last = ref_wkv6(*leaves)
            outs, cots = [y], [dy]
            if ds_last is not None:
                outs.append(s_last)
                cots.append(ds_last)
            # (one step with no s0 and no ds_last leaves logw unused)
            grads = [g if g is not None else torch.zeros_like(t)
                     for g, t in zip(torch.autograd.grad(
                         outs, leaves, cots, allow_unused=True), leaves)]
        return (*grads[:5], grads[5] if s0 is not None else None)
    if r.device.type != "cuda" and not fake:
        raise ValueError(f"wkv6_bwd runs on cuda or cpu, not {r.device}")
    if fake:  # counted, not launched (the dry run)
        kernel_costs.record("wkv6_bwd", kernel_costs.wkv6_bwd_cost(
            B, S, H, D, r.element_size(), s0 is not None,
            ds_last is not None, BWD_CHUNK[D]))
        dev = r.device
        return (*(torch.empty((B, S, H, D), dtype=r.dtype, device=dev)
                  for _ in range(3)),
                torch.empty((B, S, H, D), dtype=torch.float32, device=dev),
                torch.empty((H, D), dtype=torch.float32, device=dev),
                torch.empty((B, H, D, D), dtype=torch.float32, device=dev)
                if s0 is not None else None)
    return _launch_bwd(r, k, v, logw, u, s0, dy, ds_last)


wkv6_bwd.launches = 0


def _forward(r, k, v, logw, u, s0):
    """The kernel's launch, or on fake tensors its count and fake
    outputs."""
    if is_fake(r):  # counted, not launched (the dry run)
        B, S, H, D = r.shape
        kernel_costs.record("wkv6", kernel_costs.wkv6_cost(
            B, S, H, D, r.element_size(), s0 is not None))
        return (torch.empty((B, S, H, D), dtype=r.dtype, device=r.device),
                torch.empty((B, H, D, D), dtype=torch.float32,
                            device=r.device))
    return _launch(r, k, v, logw, u, s0)


class WKV6(torch.autograd.Function):
    """:func:`wkv6` on CUDA (or fake) tensors with its gradient: the
    forward is the kernel and saves r, k, v, logw, u and s0; the backward
    is :func:`wkv6_bwd` (s_last's cotangent None where s_last is
    unused)."""

    @staticmethod
    def forward(ctx, r, k, v, logw, u, s0):
        ctx.set_materialize_grads(False)
        y, s_last = _forward(r, k, v, logw, u, s0)
        ctx.save_for_backward(r, k, v, logw, u, s0)
        return y, s_last

    @staticmethod
    def backward(ctx, dy, ds_last):
        r, k, v, logw, u, s0 = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(r)
        return wkv6_bwd(r, k, v, logw, u, s0, dy, ds_last)


def wkv6(r: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
         logw: torch.Tensor, u: torch.Tensor,
         s0: Optional[torch.Tensor] = None
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """r, k, v: (B, S, H, d), float32 or bfloat16 alike; logw: (B, S, H, d)
    float32; u: (H, d) float32; s0: (B, H, d, d) float32 or None.  Returns
    (y (B, S, H, d) in r's dtype, s_last (B, H, d, d) float32) of the
    serial recurrence ``y_t = r_t (S + diag(u) k_t^T v_t)``,
    ``S <- diag(exp(logw_t)) S + k_t^T v_t`` from ``S = s0`` (or 0).

    CUDA tensors run the hand-written kernel, differentiable through
    :class:`WKV6` (the backward kernel) where an input requires grad; CPU
    tensors run the plain version, which autograd differentiates.  Any
    other device raises.  Fake tensors (the dry run) stand for CUDA ones:
    they return fake outputs and add the kernel's operations (the serial
    recurrence's) and bytes to ``roofline.kernel_costs.COUNTS``, and the
    backward's through :class:`WKV6`."""
    _check(r, k, v, logw, u, s0)
    fake = is_fake(r)
    if r.device.type == "cpu" and not fake:
        return ref_wkv6(r, k, v, logw, u, s0)
    if r.device.type != "cuda" and not fake:
        raise ValueError(f"wkv6 runs on cuda or cpu, not {r.device}")
    if torch.is_grad_enabled() and any(
            t is not None and t.requires_grad
            for t in (r, k, v, logw, u, s0)):
        return WKV6.apply(r, k, v, logw, u, s0)
    return _forward(r, k, v, logw, u, s0)


wkv6.launches = 0
