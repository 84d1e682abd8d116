"""Hand-written Hopper kernels of the port, with their plain versions.

  latency_hist    - masked per-lane latency histogramming for the batched
                    execution plane's p50/p99 surfaces (CUDA C++,
                    ``csrc/latency_hist.cu``)
  flash_attention - attention forward over a whole sequence, causal or
                    not, windowed or not, with GQA: the models' prefill
                    (CUDA C++, ``csrc/flash_attention.cu``)
  flash_decode    - split-KV attention of one query token per sequence
                    against its KV cache: the models' decode step (CUDA
                    C++, ``csrc/decode_attention.cu``)
  rglru_scan      - the RG-LRU linear recurrence h_t = a_t h_{t-1} + x_t
                    over a sequence, chunked: recurrentgemma's recurrent
                    layers (CUDA C++, ``csrc/rglru_scan.cu``)
  wkv6            - the RWKV-6 WKV recurrence over a d x d state per
                    head, from a given state: rwkv6's time mix (CUDA
                    C++, ``csrc/wkv6.cu``)
  exec_lanes      - the batched execution engine's closed-loop client
                    step loop over every (config x seed) lane, a block of
                    steps a launch (CUDA C++, ``csrc/exec_lanes.cu``)
  transient_lanes - the transient engine's token-ring step loop over every
                    (deployment x seed) lane, a block of steps a launch
                    (CUDA C++, ``csrc/transient_lanes.cu``)
  mva_scan        - exact MVA over every row of a demand matrix for N =
                    1..n_max clients, one warp a row, one launch (CUDA
                    C++, ``csrc/mva_scan.cu``)
  fluid_scan      - the fluid pipeline's step loop over every row of a
                    demand matrix, one warp a row, one launch (CUDA C++,
                    ``csrc/fluid_scan.cu``)

Each ships with a wrapper that launches the kernel on CUDA tensors and
runs the plain version (``ref.py``) on CPU tensors; ``ops.py`` is the
dispatch core and model code call.  Sources are compiled on first use, on
the machine with the card: importing this package builds nothing.
"""
from . import ops, ref

__all__ = ["ops", "ref"]
