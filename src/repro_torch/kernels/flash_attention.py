"""Flash attention, forward (prefill, training) and backward (training):
the hand-written CUDA kernels and their wrappers.

The forward replaces the Pallas kernel ``src/repro/kernels/
flash_attention.py:_flash_kernel``.  The CUDA source is ``csrc/flash_attention.cu``: one
block per (batch, head, query tile) walks the K/V tiles from the first its
rows can see (0, or the window's start) up to the diagonal with an online
softmax in float32 registers - bfloat16 inputs on the tensor cores
(``mma.sync`` fed by ``ldmatrix`` from a two-stage ``cp.async`` ring,
float32 accumulation), float32 inputs in float32 FMAs on the CUDA cores.
At the serving path's shapes it is bound by operations (see the source's
note).

The wrapper takes the JAX kernel's layout, q (B, H, S_q, d) and k/v
(B, H_kv, S_k, d), as any strided views whose last dimension is
contiguous, and returns (B, H, S_q, d) laid out as a (B, S_q, H, d)
tensor, so the model's ``out.transpose(1, 2).reshape(B, S, H * d)`` costs
no copy.  S_q and S_k differ only without a causal mask or a window
(cross-attention).  A view whose rows a 16-byte copy cannot read is copied
first (:func:`aligned_rows`).  A CUDA tensor launches the kernel (or the
call raises); a CPU tensor runs the plain version
:func:`repro_torch.kernels.ref.ref_attention`.

Where q, k or v requires grad (and grad mode is on) the call goes through
:class:`FlashAttention`, a ``torch.autograd.Function``: its forward also
writes each row's log-sum-exp, and its backward runs
:func:`flash_attention_bwd` - on the card the hand-written backward
kernel ``csrc/flash_attention_bwd.cu`` (P recomputed from the saved
log-sum-exp, dK and dV summed over each kv head's group inside one block:
no atomics, the same bits every run; bfloat16 at head dims 64, 128 and
256 on ``wgmma`` fed by the copy engine, laid out by :func:`bwd_plan`,
float32 on the CUDA cores).  A CPU tensor is not sent
through it: autograd differentiates the plain version.  Head dims 64, 128
and 256 train.  ``flash_attention.launches`` and
``flash_attention_bwd.launches`` count kernel launches (one per call),
and only those; a serving call passes no log-sum-exp buffer and runs the
forward kernel as before.
"""
from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch
from torch._subclasses.fake_tensor import is_fake

from ..roofline import kernel_costs
from ._build import build_library
from .ref import ref_attention

HEAD_DIMS = (16, 32, 64, 128, 256)
DTYPES = (torch.float32, torch.bfloat16)

#: head dims the backward kernel takes (bfloat16 on ``wgmma``, float32 on
#: the CUDA cores)
BWD_HEAD_DIMS = (64, 128, 256)
#: the ``wgmma`` path's tiles at head dims 64 and 128 (the same names in
#: the source): keys of a dk/dv block (64 a consumer warpgroup), query
#: rows of a dq block (64 a consumer), keys of a dq tile, and the row
#: padding of the lse2 / delta scratch.  At 256: :func:`wgmma_tiles`.
KV_KEYS, DQ_ROWS, DQ_KEYS, PAD_ROWS = 128, 128, 64, 128


def wgmma_tiles(head_dim: int) -> Tuple[int, int]:
    """(keys of a dk/dv block, keys of a dq tile) of the ``wgmma`` path
    (``WgTiles`` in the source): at d = 256, 64 keys that both consumer
    warpgroups of a dk/dv block share (they split the products, each
    holding one 64 x 256 float32 accumulator), and dq tiles of 32 keys
    (so that 128 rows of q and do and three stages of K and V fit)."""
    return (64, 32) if head_dim == 256 else (KV_KEYS, DQ_KEYS)

_lib: Optional[ctypes.CDLL] = None
_build_log = ""
_bwd_lib: Optional[ctypes.CDLL] = None
_bwd_build_log = ""


def build() -> str:
    """Compile ``csrc/flash_attention.cu`` (once per source and flags) and
    load it.  Returns ``nvcc``'s ``-Xptxas -v`` report."""
    global _lib, _build_log
    if _lib is not None:
        return _build_log
    lib, _build_log = build_library("flash_attention.cu")
    fn = lib.flash_attention_launch
    fn.argtypes = ([ctypes.c_int, ctypes.c_int] + [ctypes.c_void_p] * 5
                   + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    _lib = lib
    return _build_log


def build_bwd() -> str:
    """Compile ``csrc/flash_attention_bwd.cu`` (once per source and flags)
    and load it.  Returns ``nvcc``'s ``-Xptxas -v`` report."""
    global _bwd_lib, _bwd_build_log
    if _bwd_lib is not None:
        return _bwd_build_log
    lib, _bwd_build_log = build_library("flash_attention_bwd.cu")
    fn = lib.flash_attention_bwd_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 10
                   + [ctypes.c_int] * 7
                   + [ctypes.c_float, ctypes.c_void_p, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    fn = lib.flash_attention_bwd_wgmma_launch
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 13
                   + [ctypes.c_int] * 7
                   + [ctypes.c_float] + [ctypes.c_void_p] * 3)
    fn.restype = ctypes.c_int
    _bwd_lib = lib
    return _bwd_build_log


#: head dim -> (query rows per block, keys per tile) of the bfloat16
#: kernel (``MmaTile`` in the source)
MMA_TILES = {16: (64, 64), 32: (64, 64), 64: (128, 64), 128: (64, 64),
             256: (64, 32)}


def key_tile(head_dim: int) -> int:
    """Keys per tile of the bfloat16 kernel at ``head_dim``."""
    return MMA_TILES[head_dim][1]


def aligned_rows(t: torch.Tensor) -> torch.Tensor:
    """``t`` itself where the kernels' 16-byte copies can read its rows: a
    contiguous last dimension, a 16-byte aligned start, and every other
    stride (of a dimension longer than 1) a multiple of 16 bytes.  Else a
    dense copy of it."""
    step = 16 // t.element_size()
    if (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st % step == 0 for n, st in zip(t.shape[:-1],
                                                    t.stride()[:-1])
                    if n > 1)):
        return t
    return t.clone(memory_format=torch.contiguous_format)


def _check(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           causal: bool, window: Optional[int]) -> None:
    if q.dim() != 4 or k.dim() != 4 or v.dim() != 4:
        raise ValueError(f"q (B, H, S_q, d) and k/v (B, H_kv, S_k, d) "
                         f"expected: {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    B, H, S, D = q.shape
    if (k.shape != v.shape or k.shape[0] != B or k.shape[3] != D
            or k.shape[2] == 0
            or ((causal or window is not None) and k.shape[2] != S)):
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} (S_q == "
                         f"S_k where causal or windowed, S_k >= 1)")
    if k.shape[1] == 0 or H % k.shape[1] != 0:
        raise ValueError(f"{H} query heads do not group over {k.shape[1]} "
                         f"kv heads")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in DTYPES:
        raise TypeError(f"q, k, v must share float32 or bfloat16: "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"tensors on different devices: {q.device}, "
                         f"{k.device}, {v.device}")
    if window is not None and window < 1:
        raise ValueError(f"window must be None or at least 1: {window}")


def _launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
            causal: bool, window: Optional[int], with_lse: bool = False
            ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """The forward kernel: (out, the float32 (B, H, S_q) log-sum-exp with
    ``with_lse``, else None - the serving path's null pointer)."""
    B, H, S, D = q.shape
    if D not in HEAD_DIMS:
        raise ValueError(f"head dim {D} not in the kernel's {HEAD_DIMS}")
    fake = is_fake(q)
    if not fake:
        q, k, v = (aligned_rows(t) for t in (q, k, v))
    out = torch.empty((B, S, H, D), dtype=q.dtype,
                      device=q.device).transpose(1, 2)
    lse = (torch.empty((B, H, S), dtype=torch.float32, device=q.device)
           if with_lse else None)
    if fake:  # counted, not launched (the dry run)
        kernel_costs.record("flash_attention", kernel_costs.
                            flash_attention_cost(
                                B, H, k.shape[1], S, k.shape[2], D,
                                q.element_size(), causal, window))
        return out, lse
    if out.numel() == 0:
        return out, lse
    build()
    strides = (ctypes.c_longlong * 12)(*(
        s for t in (q, k, v, out) for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _lib.flash_attention_launch(
            int(q.dtype == torch.bfloat16), D, q.data_ptr(), k.data_ptr(),
            v.data_ptr(), out.data_ptr(),
            lse.data_ptr() if lse is not None else None, B, H, k.shape[1],
            S, k.shape[2], int(causal), window or 0, 1.0 / math.sqrt(D),
            strides, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention.launches += 1
    return out, lse


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


#: ints of one record of a plan's walk table (``BwdPlan.walks``)
WALK_INTS = 12


@dataclass(frozen=True)
class BwdPlan:
    """The launch plan of the bfloat16 ``wgmma`` backward for one call: the
    kernels' tiles and grids, and the walk of every block, which the
    kernel reads from :attr:`walks`.

    * dk/dv: one block per (kv head and batch, group share, ``kv_keys``
      keys), grid ``kv_grid`` = (H_kv B ``n_gsplit``, key blocks); it
      walks the heads of its share of the kv head's group and, for each,
      the query tiles of ``kv_q_tile`` rows that see its keys: 128 at
      d = 64 (64 at d = 128 and 256, where the accumulators take the
      registers), or 16, 32 or 64 where S_q is smaller (whisper's 16
      queries do not pad 48 rows).  At d = 64 and 128 a block has 128
      keys, 64 a consumer warpgroup; at d = 256 it has 64, which both
      consumers take (one computes P^T and dV, the other dS^T and dK).
    * The group split (d = 256): where the (b, kv head, key block) blocks
      are fewer than the SMs (recurrentgemma-2b's one kv head for 10
      query heads), the group's heads are split over ``n_gsplit`` blocks
      of contiguous heads, as many as fill the card; each writes float32
      dk / dv partials and the merge launch sums them in split order 0,
      1, ... (the same bits every run).
    * dq: one block per (head and batch, 128 query rows, key split), grid
      ``dq_grid`` = (H B, query tiles, ``n_split``), the longest causal
      walks first (the kernel takes the tiles from the last); split s
      takes the s-th share of the key tiles (``dq_keys`` keys) the rows
      see.  Where the dq blocks are fewer than the SMs (few queries:
      whisper's cross-attention) the keys are split until they fill the
      SMs that the dk/dv blocks leave idle in their last wave (or a wave
      of their own); each split then writes a float32 partial and the
      merge launch sums them in split order.
    * Both roles run in one launch of :attr:`n_blocks` blocks, the dk/dv
      blocks first (key block major, so the longest causal walks start
      first), then the dq blocks.
    * ``s_pad``: rows of the lse2 / delta scratch per (b, h), S_q rounded
      up to ``PAD_ROWS``.
    * ``walks``: ``WALK_INTS`` ints a record, one record per key block
      (dk/dv), then one per (split, query tile) of dq, at ``kv_grid[1] +
      split * dq_grid[1] + tile``.  A record is (0, the block's tiles
      [lo, hi), 0), then for each of the two consumer warpgroups (its keys
      of a dk/dv block, 64 rows of a dq block) the tiles it computes,
      [vis_lo, vis_hi), and of those the ones it computes without a mask,
      [full_lo, full_hi): the others cross the diagonal, the window's
      edge or (dq) the last key."""
    B: int
    H: int
    H_kv: int
    S_q: int
    S_k: int
    D: int
    causal: bool
    window: Optional[int]
    kv_q_tile: int
    kv_grid: Tuple[int, int]
    dq_grid: Tuple[int, int, int]
    s_pad: int
    walks: Tuple[int, ...] = field(repr=False, compare=False)
    n_gsplit: int = 1

    @property
    def n_split(self) -> int:
        return self.dq_grid[2]

    @property
    def kv_keys(self) -> int:
        return wgmma_tiles(self.D)[0]

    @property
    def dq_keys(self) -> int:
        return wgmma_tiles(self.D)[1]

    def group_heads(self, share: int) -> Tuple[int, int]:
        """The heads [lo, hi) of a kv head's group that group share
        ``share`` of the dk/dv blocks walks (as the kernel splits them)."""
        group = self.H // self.H_kv
        return (share * group // self.n_gsplit,
                (share + 1) * group // self.n_gsplit)

    @property
    def n_blocks(self) -> int:
        """Blocks of the one launch: dk/dv's, then dq's."""
        return math.prod(self.kv_grid) + math.prod(self.dq_grid)

    def c_args(self) -> Tuple[int, ...]:
        """The 5 ints the C entry point receives beside the walk table:
        the dk/dv query tile, the key splits, the padded rows, the table's
        records (which the C side checks against its tiles) and the group
        splits."""
        return (self.kv_q_tile, self.n_split, self.s_pad,
                len(self.walks) // WALK_INTS, self.n_gsplit)


def _span(vis_lo: int, full_lo: int, full_hi: int, vis_hi: int, lo: int,
          hi: int) -> Tuple[int, int, int, int]:
    """A consumer's (vis_lo, full_lo, full_hi, vis_hi) inside the block's
    walk [lo, hi), with full_lo <= full_hi (an empty unmasked run)."""
    vis_lo = min(max(vis_lo, lo), hi)
    vis_hi = min(max(vis_hi, vis_lo), hi)
    full_lo = min(max(full_lo, vis_lo), vis_hi)
    return vis_lo, full_lo, min(max(full_hi, full_lo), vis_hi), vis_hi


def _dkdv_record(kb: int, bq: int, S_q: int, S_k: int, causal: bool,
                 w: int, kv_keys: int) -> Tuple[int, ...]:
    """Key block ``kb`` (``kv_keys`` keys): the query tiles (``bq`` rows)
    that see a key of it; consumer c's keys [kw, kw + 63] (its half of
    128, or at d = 256 all 64, the same for both) are visible to query
    tile t from the tile holding kw (causal) to the last one with a query
    within the window of kw + 63, and unmasked from the first tile whose
    first query sees kw + 63 to the last whose last query sees kw."""
    k0 = kb * kv_keys
    lo = k0 // bq if causal else 0
    hi = _cdiv(min(S_q, k0 + kv_keys - 1 + w) if w else S_q, bq)
    rec = [0, lo, hi, 0]
    for c in (0, 1):
        kw = k0 + (64 * c if kv_keys == 128 else 0)
        if kw >= S_k:  # no keys: the consumer does not walk
            rec += [lo, lo, lo, lo]
            continue
        rec += _span(kw // bq if causal else lo,
                     _cdiv(kw + 63, bq) if causal else lo,
                     (kw + w) // bq if w else hi,
                     _cdiv(kw + 63 + w, bq) if w else hi, lo, hi)
    return tuple(rec)


def _dq_record(qt: int, split: int, n_split: int, S_k: int, causal: bool,
               w: int, dq_keys: int) -> Tuple[int, ...]:
    """dq block (query tile ``qt``, split): its share of the key tiles
    (``dq_keys`` keys) the tile's rows see; consumer c's rows [qw, qw +
    63] see key tile t from the first with a key within the window of qw
    to the one holding qw + 63 (causal), unmasked from the first whose
    first key qw + 63 sees to the last whose last key qw sees and lies
    below S_k."""
    q0, n_kt = qt * DQ_ROWS, _cdiv(S_k, dq_keys)
    lo = max(0, q0 - w + 1) // dq_keys if w else 0
    hi = min(n_kt, (q0 + DQ_ROWS - 1) // dq_keys + 1) if causal else n_kt
    n = max(0, hi - lo)
    lo, hi = lo + split * n // n_split, lo + (split + 1) * n // n_split
    rec = [0, lo, hi, 0]
    for c in (0, 1):
        qw = q0 + 64 * c
        rec += _span((qw - w + 1) // dq_keys if w else lo,
                     (qw + 63 - w) // dq_keys + 1 if w else lo,
                     min((qw + 1) // dq_keys if causal else n_kt,
                         S_k // dq_keys),
                     (qw + 63) // dq_keys + 1 if causal else hi, lo, hi)
    return tuple(rec)


@functools.lru_cache(maxsize=None)
def bwd_plan(B: int, H: int, H_kv: int, S_q: int, S_k: int, D: int,
             causal: bool, window: Optional[int], n_sms: int) -> BwdPlan:
    """The launch plan of the ``wgmma`` backward (see :class:`BwdPlan`)
    on a card of ``n_sms`` SMs."""
    if D not in BWD_HEAD_DIMS:
        raise ValueError(f"head dim {D} not in the wgmma path's "
                         f"{BWD_HEAD_DIMS}")
    kv_keys, dq_keys = wgmma_tiles(D)
    kv_q_tile = (16 if S_q <= 16 else 32 if S_q <= 32 else
                 64 if S_q <= 64 or D >= 128 else 128)
    n_qt, n_kt = _cdiv(S_q, DQ_ROWS), _cdiv(S_k, dq_keys)
    kv_blocks = H_kv * B * _cdiv(S_k, kv_keys)
    n_gsplit = 1
    if D == 256 and kv_blocks < n_sms:
        # the group's heads over as many blocks as fill the card
        n_gsplit = max(1, min(H // H_kv, n_sms // kv_blocks))
    kv_grid = (H_kv * B * n_gsplit, _cdiv(S_k, kv_keys))
    blocks = n_qt * H * B
    n_split = 1
    if blocks < n_sms:
        # the SMs the dk/dv blocks leave idle in their last wave, or else
        # a wave of their own
        free = -math.prod(kv_grid) % n_sms
        n_split = max(1, min(n_kt, free // blocks if free >= blocks
                             else _cdiv(n_sms, blocks)))
    w = window or 0
    walks = [x for kb in range(kv_grid[1])
             for x in _dkdv_record(kb, kv_q_tile, S_q, S_k, causal, w,
                                   kv_keys)]
    walks += [x for split in range(n_split) for qt in range(n_qt)
              for x in _dq_record(qt, split, n_split, S_k, causal, w,
                                  dq_keys)]
    return BwdPlan(B, H, H_kv, S_q, S_k, D, causal, window, kv_q_tile,
                   kv_grid, (H * B, n_qt, n_split),
                   _cdiv(S_q, PAD_ROWS) * PAD_ROWS, tuple(walks), n_gsplit)


@functools.lru_cache(maxsize=None)
def _device_walks(plan: BwdPlan, index: int) -> torch.Tensor:
    """``plan.walks`` on card ``index``, copied once per plan and card and
    kept (a CUDA graph that captured a launch reads it at each replay)."""
    return torch.tensor(plan.walks, dtype=torch.int32,
                        device=torch.device("cuda", index))


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch_bwd_wgmma(q, k, v, out, lse, dout, dq, dk, dv, causal: bool,
                      window: Optional[int]) -> None:
    """The bfloat16 ``wgmma`` path (head dims 64, 128 and 256)."""
    B, H, S, D = q.shape
    lse = lse.contiguous()
    with torch.cuda.device(q.device):
        index = torch.cuda.current_device()
        plan = bwd_plan(B, H, k.shape[1], S, k.shape[2], D, causal, window,
                        _sm_count(index))
        walks = _device_walks(plan, index)
        scratch = torch.empty(2 * B * H * plan.s_pad, dtype=torch.float32,
                              device=q.device)
        part = (torch.empty((plan.n_split, B, H, S, D), dtype=torch.float32,
                            device=q.device) if plan.n_split > 1 else None)
        kv_part = (torch.empty((2, plan.n_gsplit) + tuple(k.shape),
                               dtype=torch.float32, device=q.device)
                   if plan.n_gsplit > 1 else None)
        strides = (ctypes.c_longlong * 24)(*(
            s for t in (q, k, v, out, dout, dq, dk, dv)
            for s in t.stride()[:3]))
        c_plan = (ctypes.c_int * 5)(*plan.c_args())
        stream = torch.cuda.current_stream().cuda_stream
        err = _bwd_lib.flash_attention_bwd_wgmma_launch(
            D, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(), lse.data_ptr(), scratch.data_ptr(),
            part.data_ptr() if part is not None else None,
            kv_part.data_ptr() if kv_part is not None else None,
            walks.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, H, k.shape[1], S, k.shape[2],
            int(causal), window or 0, 1.0 / math.sqrt(D), strides, c_plan,
            stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA "
                           f"error {err}")


def _launch_bwd(q, k, v, out, lse, dout, causal: bool,
                window: Optional[int]):
    B, H, S, D = q.shape
    if D not in BWD_HEAD_DIMS:
        raise ValueError(f"head dim {D} not in the backward kernel's "
                         f"{BWD_HEAD_DIMS}")
    fake = is_fake(q)
    if not fake:
        # the tensor-core paths copy rows in 16-byte pieces
        q, k, v, dout, out = (aligned_rows(t) for t in (q, k, v, dout, out))
    dq = torch.empty((B, S, H, D), dtype=q.dtype,
                     device=q.device).transpose(1, 2)
    dk = torch.empty(k.shape, dtype=k.dtype, device=k.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=v.device)
    if fake:  # counted, not launched (the dry run)
        kernel_costs.record("flash_attention_bwd", kernel_costs.
                            flash_attention_bwd_cost(
                                B, H, k.shape[1], S, k.shape[2], D,
                                q.element_size(), causal, window))
        return dq, dk, dv
    if dq.numel() == 0:
        return dq, dk.zero_(), dv.zero_()
    build_bwd()
    if q.dtype == torch.bfloat16:
        _launch_bwd_wgmma(q, k, v, out, lse, dout, dq, dk, dv, causal,
                          window)
        flash_attention_bwd.launches += 1
        return dq, dk, dv
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 24)(*(
        s for t in (q, k, v, out, dout, dq, dk, dv) for s in t.stride()[:3]))
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        err = _bwd_lib.flash_attention_bwd_launch(
            D, q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            dout.data_ptr(),
            lse.contiguous().data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), B, H, k.shape[1], S, k.shape[2],
            int(causal), window or 0, 1.0 / math.sqrt(D), strides, stream)
    if err != 0:
        raise RuntimeError(f"flash_attention_bwd kernel launch failed: CUDA "
                           f"error {err}")
    flash_attention_bwd.launches += 1
    return dq, dk, dv


def flash_attention_bwd(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        out: torch.Tensor, lse: torch.Tensor,
                        dout: torch.Tensor, *, causal: bool = True,
                        window: Optional[int] = None
                        ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The gradients (dq, dk, dv) of :func:`flash_attention` at (q, k, v),
    given its output ``out``, its float32 log-sum-exp ``lse`` (B, H, S_q)
    and the output's cotangent ``dout`` (q's shape and dtype).  CUDA
    tensors run the hand-written kernel (head dims 64, 128, 256); CPU
    tensors autograd through the plain version (``out`` and ``lse`` are
    not read there); fake tensors are counted (:func:`flash_attention`)."""
    _check(q, k, v, causal, window)
    fake = is_fake(q)
    if q.device.type == "cpu" and not fake:
        with torch.enable_grad():
            qkv = [t.detach().requires_grad_() for t in (q, k, v)]
            o = ref_attention(*qkv, causal=causal, window=window)
            return torch.autograd.grad(o, qkv, dout)
    if q.device.type != "cuda" and not fake:
        raise ValueError(f"flash_attention_bwd runs on cuda or cpu, not "
                         f"{q.device}")
    return _launch_bwd(q, k, v, out, lse, dout, causal, window)


flash_attention_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """:func:`flash_attention` on CUDA tensors with its gradient: the
    forward kernel also writes the log-sum-exp and saves q, k, v, the
    output and it; the backward is the backward kernel."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool, window: Optional[int]):
        out, lse = _launch(q, k, v, causal, window, with_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.window = causal, window
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd(q, k, v, out, lse, dout,
                                         causal=ctx.causal,
                                         window=ctx.window)
        return dq, dk, dv, None, None


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True,
                    window: Optional[int] = None) -> torch.Tensor:
    """q: (B, H, S_q, d); k/v: (B, H_kv, S_k, d), H % H_kv == 0, float32 or
    bfloat16; S_q == S_k when ``causal`` or with a ``window``.  Returns
    (B, H, S_q, d) in q's dtype.  With a ``window``, query i sees key j
    only where ``i - j < window`` (local attention).

    CUDA tensors run the hand-written kernel (head dims 16, 32, 64, 128,
    256), differentiable through :class:`FlashAttention` where an input
    requires grad; CPU tensors run the plain version, which autograd
    differentiates.  Any other device raises.

    Fake tensors (``torch._subclasses.fake_tensor``, on any device) stand
    for the card's tensors in the dry run: the call returns fake outputs
    of the kernel's shapes, adds the kernel's operations and bytes to
    ``roofline.kernel_costs.COUNTS`` (the backward's too, through
    :class:`FlashAttention`), and never runs the plain version, which
    would hold the whole S x S score matrix the kernel never holds."""
    _check(q, k, v, causal, window)
    fake = is_fake(q)
    if q.device.type == "cpu" and not fake:
        return ref_attention(q, k, v, causal=causal, window=window)
    if q.device.type != "cuda" and not fake:
        raise ValueError(f"flash_attention runs on cuda or cpu, not "
                         f"{q.device}")
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttention.apply(q, k, v, causal, window)
    return _launch(q, k, v, causal, window)[0]


flash_attention.launches = 0
