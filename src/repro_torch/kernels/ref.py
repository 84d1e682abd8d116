"""Plain PyTorch versions of the port's kernels (the ``ref.py`` contract).

Small, obviously-correct implementations that follow the reference's own
definitions.  The CPU path runs them, the tests hold them against the JAX
package, and the card's kernels are held against them bit for bit.
"""
from __future__ import annotations

import torch

#: Elements of the (L, chunk, B+1) comparison tensor built per pass; keeps
#: the plain histogram's working set to a few hundred MB at any N.
_HIST_CHUNK_ELEMS = 1 << 26


def ref_latency_hist(samples: torch.Tensor, valid: torch.Tensor,
                     edges: torch.Tensor) -> torch.Tensor:
    """Masked histogram per lane.  samples/valid: (L, N); edges: (L, B+1).
    Bin = #{j : edges_j < sample} - 1, clipped to [0, B) - the transient
    plane's searchsorted-left binning written as a comparison count, so a
    NaN sample lands in bin 0 exactly as in the reference (where
    ``torch.searchsorted`` would put it past the end).  A sample counts
    where ``valid > 0``.  Returns (L, B) int32, chunked over N."""
    n_lanes, n = samples.shape
    n_bins = edges.shape[-1] - 1
    out = torch.zeros((n_lanes, n_bins), dtype=torch.int64,
                      device=samples.device)
    step = max(1, _HIST_CHUNK_ELEMS // max(n_lanes * (n_bins + 1), 1))
    for lo in range(0, n, step):
        x = samples[:, lo:lo + step]
        idx = (edges[:, None, :] < x[..., None]).sum(dim=-1) - 1
        idx = idx.clamp(0, n_bins - 1)
        ok = (valid[:, lo:lo + step] > 0).to(torch.int64)
        out.scatter_add_(1, idx, ok)
    return out.to(torch.int32)
