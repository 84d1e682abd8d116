"""Layer-level probe of the MoE layer's two distributed formulations (port
of ``launch/moe_a2a_probe.py``).

Counts one qwen3-moe-30b-a3b MoE layer, forward and backward, at the
``train_4k`` cell's per-shard token counts (B = 256, S = 4096) on the
production (data=16, model=16) mesh, as the dry run counts a step: on
fake tensors, as rank 0 of a fake process group (``launch/dryrun.py``),
with the experts split over "model" and the router replicated, and the
layer's input requiring grad (the layers below it take its gradient):

* ``gshard``: the port's gather-at-use formulation - each rank takes its
  share of the tokens (split over data x model, 4096 a rank), gathers the
  experts' weights (an all-gather over "model"), runs the GShard capacity
  dispatch (``models.moe.apply_moe_gshard``) over every expert, and the
  backward reduce-scatters the weights' gradients into the experts'
  shards (and sums them over "data");
* ``a2a``: ``runtime/moe_a2a.make_moe_a2a`` - each rank holds its
  experts' block and runs it as it is (no gather); the tokens go to the
  experts' ranks and back in two ``all_to_all_single`` each way, and the
  layer's output rows are gathered back over "model".

This pair differs from the reference's.  The reference's ``gshard`` is
the automatic-SPMD one-hot dispatch, which XLA's partitioner lowers to
all-gathers of the *tokens* across the expert ranks; the port has no
automatic partitioner, and the sharded steps gather the *weights* at use
instead.  So the reference compares token all-gathers with all-to-alls,
the port weight all-gathers (and their gradients' reduce-scatters) with
all-to-alls.

Prints, for each, the per-layer collective bytes and FLOPs per device,
then the reduction and the collective term of 48 such layers at the
card's link rate (``roofline/analysis.LINK_BW``).

  PYTHONPATH=src python -m repro_torch.launch.moe_a2a_probe
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from ..configs import get_config
from ..configs.base import ModelConfig
from ..roofline.analysis import LINK_BW
from ..roofline.hlo import CollectiveCounter
from .dryrun import fake_mesh
from .mesh import MeshShape, make_production_mesh


def _nested(named: Dict[str, torch.Tensor]) -> dict:
    """{"experts.w_up": t, ...} -> {"experts": {"w_up": t}, ...}."""
    out: dict = {}
    for name, t in named.items():
        *path, leaf = name.split(".")
        node = out
        for key in path:
            node = node.setdefault(key, {})
        node[leaf] = t
    return out


def probe(cfg: Optional[ModelConfig] = None,
          mesh_shape: Optional[MeshShape] = None, batch: int = 256,
          seq: int = 4096, verbose: bool = True) -> dict:
    """{formulation: {"collectives": {HLO name: {count, bytes}}, "bytes":
    their sum, "flops": FLOPs}} per device for one MoE layer of ``cfg``
    (qwen3-moe-30b-a3b's by default), forward and backward, on a batch of
    ``batch`` x ``seq`` tokens over a (data, model) mesh of
    ``mesh_shape`` (the production (16, 16) by default)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import (Partial, Replicate, Shard,
                                          distribute_tensor)
    from torch.utils.flop_counter import FlopCounterMode

    from ..models.moe import MoE, apply_moe_gshard
    from ..runtime.moe_a2a import make_moe_a2a

    cfg = cfg or get_config("qwen3-moe-30b-a3b")
    mesh_shape = mesh_shape or make_production_mesh()
    sizes = mesh_shape.shape
    D, M = sizes["data"], sizes["model"]
    moe, d = cfg.moe, cfg.d_model
    results = {}
    with fake_mesh(mesh_shape) as mesh, FakeTensorMode(
            allow_non_fake_inputs=True):
        layer = MoE(cfg, None, cfg.dtype(), "cpu")
        params = {}
        for name, p in layer.named_parameters():
            pl = [Replicate(), Shard(0) if name.startswith("experts.")
                  else Replicate()]
            params[name] = distribute_tensor(p.detach(), mesh,
                                             pl).requires_grad_()
        everywhere = [Partial(), Partial()]  # each rank's own tokens
        for name in ("gshard", "a2a"):
            for p in params.values():
                p.grad = None
            counter = CollectiveCounter()
            with FlopCounterMode(display=False) as flops, counter:
                if name == "gshard":
                    x = torch.zeros((batch // (D * M), seq, d),
                                    dtype=cfg.cdtype(), requires_grad=True)
                    whole = {n: p.full_tensor(grad_placements=everywhere)
                             for n, p in params.items()}
                    out, aux = apply_moe_gshard(_nested(whole), x, moe,
                                                cfg.mlp_kind)
                else:
                    x = torch.zeros((batch // D, seq, d), dtype=cfg.cdtype(),
                                    requires_grad=True)
                    held = {n: p if n.startswith("experts.")
                            else p.full_tensor(grad_placements=everywhere)
                            for n, p in params.items()}
                    out, aux = make_moe_a2a(mesh, moe, cfg.mlp_kind, d)(
                        _nested(held), x)
                (out.float().sum() + aux).backward()
            stats = {op: dict(v) for op, v in counter.stats.items()}
            results[name] = dict(collectives=stats,
                                 bytes=counter.total_bytes(),
                                 flops=float(flops.get_total_flops()))
            if verbose:
                print(f"{name:7s} per-layer collective bytes/dev = "
                      f"{results[name]['bytes']:.3e}  flops/dev = "
                      f"{results[name]['flops']:.3e}", flush=True)
                for op, v in sorted(stats.items()):
                    print(f"         {op}: n={v['count']} "
                          f"bytes={v['bytes']:.3e}", flush=True)
    return results


def main() -> None:
    results = probe()
    g, a = results["gshard"]["bytes"], results["a2a"]["bytes"]
    print(f"\nper-layer collective traffic: gshard {g:.3e} B -> a2a {a:.3e} B "
          f"({g / max(a, 1):.2f}x reduction)")
    print(f"cell-level (x48 layers): {48 * g / LINK_BW:.2f}s -> "
          f"{48 * a / LINK_BW:.2f}s collective term at "
          f"{LINK_BW / 1e9:.0f} GB/s a card")


if __name__ == "__main__":
    main()
