"""Sharding rules: parameter / batch / cache specs per architecture (port of
``runtime/sharding.py``).

A spec is a tuple with one entry per tensor dim: ``None`` (not sharded),
a mesh axis name, or a tuple of axis names (the dim split over several
axes, major first).  It is the reference's ``PartitionSpec`` with the
stacked ``(repeats,)`` axis of a segment's parameters and caches dropped:
the port keeps one module per layer, and its rules are keyed on the
port's parameter names (``layers.3.attn.w_q``; ``models/convert.py``'s
``_layer_slots`` maps them to the reference's ``segments/0/0/attn/w_q``).
The rules need only the mesh's axis names and sizes, so a policy on a
production layout (``launch/mesh.py:make_production_mesh``) is evaluated
with no process group; on a ``DeviceMesh``, :func:`placements` realises a
spec as ``Shard`` / ``Replicate`` placements, with which
:func:`distribute_model` lays a model's parameters out as ``DTensor``s.

Baseline policy (v1 - the recorded roofline baseline):

  * vocab & unembed         -> "model" (sharded logits + sharded logsumexp CE)
  * attention q/o           -> "model" over heads, only when n_heads % |model|
                               == 0; else replicate
  * attention k/v           -> "model" only when n_kv_heads % |model| == 0
                               (GQA with few KV heads replicates K/V - the
                               MaxText convention)
  * mlp / experts           -> "model" (column-, then row-parallel; experts
                               sharded on the expert axis = EP)
  * rglru channel axis      -> "model" (gates, conv, state all channel-local)
  * rwkv6 projections       -> "model" (64 heads divide 16)
  * batch                   -> ("pod", "data")
  * decode KV cache         -> batch over data axes, sequence over "model"
                               (distributed split-KV decode)
  * optimizer moments       -> same as params, or ZeRO-1 (first divisible dim
                               over "data") when enabled

Perf levers beyond the baseline:
  zero1                  - ZeRO-1: f32 moments sharded over "data"
  shard_qkv_by_flat_dim  - shard q/k/v on the flat head*dim axis
  dp_only                - pure DP: params replicated, batch over every axis
  fsdp                   - params sharded over "model", gathered per use
  seq_dp                 - context parallelism: sequence over the "pod" axis

ZeRO-1 picks the first divisible unsharded dim of the port's per-layer
moment; where the reference's choice is its stacked repeats axis (the
repeats divisible by |data|) the port has no such axis and picks the next
one.
"""
from __future__ import annotations

import re
from itertools import combinations
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..launch.mesh import mesh_shape

Spec = Tuple[Any, ...]


def _divisible(n: int, k: int) -> bool:
    return k > 0 and n % k == 0


def _entry(axes: Optional[Tuple[str, ...]]):
    """A tuple of axes as a spec entry, as ``PartitionSpec`` keeps it: None
    for no axis, the name for one."""
    if not axes:
        return None
    return axes[0] if len(axes) == 1 else tuple(axes)


def _named(params) -> Dict[str, torch.Tensor]:
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


#: the K/V cache leaves of a cache tree, by their path
_KV_LEAF = re.compile(r"(?:^|/)(k|v|cross_k|cross_v)$")


class ShardingPolicy:
    """Computes specs for params/batches/caches on a given mesh (a
    ``launch.mesh.MeshShape`` or a named ``DeviceMesh``)."""

    def __init__(self, cfg: ModelConfig, mesh,
                 zero1: bool = False,
                 shard_qkv_by_flat_dim: bool = False,
                 seq_shard_cache: bool = True,
                 dp_only: bool = False,
                 fsdp: bool = False,
                 seq_dp: bool = False):
        self.cfg = cfg
        self.mesh = mesh
        shape = mesh_shape(mesh)
        self.axis_names = shape.axis_names
        self.sizes = shape.shape
        self.model_size = self.sizes["model"]
        self.dp_axes = tuple(a for a in ("pod", "data")
                             if a in self.axis_names)
        self.zero1 = zero1
        self.shard_qkv_by_flat_dim = shard_qkv_by_flat_dim
        self.seq_shard_cache = seq_shard_cache
        self.dp_only = dp_only
        self.fsdp = fsdp
        if dp_only or fsdp:
            self.dp_axes = self.dp_axes + ("model",)
        self.seq_dp = seq_dp

    # -- parameter specs -----------------------------------------------------
    def param_spec(self, name: str, shape: Tuple[int, ...]) -> Spec:
        """The spec of the port's parameter ``name`` of ``shape``."""
        cfg, M = self.cfg, self.model_size
        n = len(shape)
        rep = (None,) * n
        if self.dp_only:
            # MoE experts stay expert-parallel over "model" (EP+DP)
            if re.search(r"moe\.experts\.", name) and _divisible(shape[0], M):
                return ("model",) + (None,) * (n - 1)
            return rep
        if self.fsdp:
            for i, dim in enumerate(shape):
                if _divisible(dim, M):
                    return rep[:i] + ("model",) + rep[i + 1:]
            return rep
        heads_ok = _divisible(cfg.n_heads, M)
        kv_ok = _divisible(cfg.n_kv_heads, M)
        flat = self.shard_qkv_by_flat_dim

        def last_dim_model_if(cond) -> Spec:
            if cond and _divisible(shape[-1], M):
                return (None,) * (n - 1) + ("model",)
            return rep

        def first_dim_model_if(cond) -> Spec:
            if cond and _divisible(shape[0], M):
                return ("model",) + (None,) * (n - 1)
            return rep

        # embeddings
        if re.search(r"embed\.tokens$", name):
            return first_dim_model_if(True)
        if re.search(r"embed\.unembed$", name):
            return last_dim_model_if(True)

        # attention
        if re.search(r"(attn|xattn)\.w_q$", name):
            return last_dim_model_if(heads_ok or flat)
        if re.search(r"(attn|xattn)\.w_[kv]$", name):
            return last_dim_model_if(kv_ok or flat)
        if re.search(r"(attn|xattn)\.b_q$", name):
            return last_dim_model_if(heads_ok or flat)
        if re.search(r"(attn|xattn)\.b_[kv]$", name):
            return last_dim_model_if(kv_ok or flat)
        if re.search(r"(attn|xattn)\.w_o$", name):
            return first_dim_model_if(heads_ok or flat)

        # MoE
        if re.search(r"moe\.router$", name):
            return rep
        if re.search(r"moe\.experts\.", name):
            return first_dim_model_if(True)   # stacked (E, d_in, d_out): EP
        if re.search(r"moe\.shared\.w_(gate|up)$", name):
            return last_dim_model_if(True)
        if re.search(r"moe\.shared\.w_down$", name):
            return first_dim_model_if(True)

        # dense MLP
        if re.search(r"mlp\.w_(gate|up)$", name):
            return last_dim_model_if(True)
        if re.search(r"mlp\.w_down$", name):
            return first_dim_model_if(True)

        # RG-LRU: channel axis (last dim of in-projs, both dims of gates)
        if re.search(r"rec\.(w_in_(rnn|gate)|conv_[wb]|w_[ax])$", name):
            return last_dim_model_if(True)
        if re.search(r"rec\.(b_[ax]|lambda)$", name):
            return last_dim_model_if(True)
        if re.search(r"rec\.w_out$", name):
            return first_dim_model_if(True)

        # RWKV6 time-mix / channel-mix
        if re.search(r"tm\.w_[rkvg]$", name):
            return last_dim_model_if(_divisible(cfg.n_heads, M))
        if re.search(r"tm\.w_o$", name):
            return first_dim_model_if(_divisible(cfg.n_heads, M))
        if re.search(r"tm\.u$", name):
            return first_dim_model_if(True)
        if re.search(r"tm\.ln_x_(scale|bias)$", name):
            return ("model",) if _divisible(cfg.n_heads, M) else (None,)
        if re.search(r"cm\.w_k$", name):
            return last_dim_model_if(True)
        if re.search(r"cm\.w_v$", name):
            return first_dim_model_if(True)

        # norms, small loras, mus, biases: replicated
        return rep

    def params_shardings(self, params) -> Dict[str, Spec]:
        """{name: spec} for a model (meta tensors will do) or a mapping of
        names to tensors."""
        return {name: self.param_spec(name, tuple(p.shape))
                for name, p in _named(params).items()}

    def opt_state_shardings(self, params) -> Dict[str, Any]:
        p_sh = self.params_shardings(params)
        if self.zero1:
            shapes = {n: tuple(p.shape) for n, p in _named(params).items()}
            m = {n: self._zero1_of(spec, shapes[n])
                 for n, spec in p_sh.items()}
        else:
            m = p_sh
        return {"m": m, "v": m, "step": ()}

    def _zero1_of(self, spec: Spec, shape: Tuple[int, ...]) -> Spec:
        """ZeRO-1: additionally shard the first *divisible* unsharded dim of
        the f32 moments over "data" (falls back to the param spec)."""
        n_data = self.sizes["data"]
        for i, s in enumerate(spec):
            if s is None and _divisible(shape[i], n_data):
                return spec[:i] + ("data",) + spec[i + 1:]
        return spec

    # -- data / activation specs ----------------------------------------------
    def dp_for(self, n: int) -> Optional[Tuple[str, ...]]:
        """Largest data-parallel axis subset that evenly divides ``n``
        (subsets of the dp axes, largest first)."""
        candidates = []
        for r in range(len(self.dp_axes), 0, -1):
            for combo in combinations(self.dp_axes, r):
                size = 1
                for a in combo:
                    size *= self.sizes[a]
                candidates.append((size, combo))
        candidates.sort(key=lambda t: -t[0])
        for size, combo in candidates:
            if _divisible(n, size):
                return combo
        return None

    def batch_spec(self) -> Spec:
        return (_entry(self.dp_axes),)  # batch dim over (pod, data)

    def batch_shardings(self, batch: Mapping[str, torch.Tensor]
                        ) -> Dict[str, Spec]:
        out = {}
        for key, leaf in batch.items():
            shape = tuple(leaf.shape)
            b_axes = self.dp_for(shape[0])
            spec = [_entry(b_axes)] + [None] * (len(shape) - 1)
            if (self.seq_dp and len(shape) >= 2
                    and "pod" in self.axis_names
                    and "pod" not in (b_axes or ())
                    and _divisible(shape[1], self.sizes["pod"])):
                spec[1] = "pod"
            out[key] = tuple(spec)
        return out

    def activation_spec(self) -> Spec:
        return (_entry(self.dp_axes), None, None)

    # -- cache specs -------------------------------------------------------------
    def cache_shardings(self, caches) -> Any:
        """The port's per-layer caches (a list of dicts, as
        ``models.init_cache`` gives them) -> the same tree of specs.
        K/V (B, S, H_kv, d): batch over data axes, sequence over "model"
        (distributed split-KV); recurrent states: batch over data axes,
        channels (or WKV heads) over "model" when divisible."""
        M = self.model_size

        def dp_for(n: int):
            return _entry(self.dp_for(n))

        def assign(path: str, leaf) -> Spec:
            shape = tuple(leaf.shape)
            if _KV_LEAF.search(path) and len(shape) == 4:
                seq_ok = self.seq_shard_cache and _divisible(shape[1], M)
                return (dp_for(shape[0]), "model" if seq_ok else None,
                        None, None)
            if re.search(r"(?:^|/)pos$", path):
                return (None,) * len(shape)
            if re.search(r"(?:^|/)wkv$", path) and len(shape) == 4:
                # (B, H, K, V): heads over model
                h_ok = _divisible(shape[1], M)
                return (dp_for(shape[0]), "model" if h_ok else None,
                        None, None)
            if re.search(r"(?:^|/)(h|conv)$", path):
                # rglru state: channel axis (last) over model
                ch_ok = _divisible(shape[-1], M)
                return ((dp_for(shape[0]),) + (None,) * (len(shape) - 2)
                        + ("model" if ch_ok else None,))
            if re.search(r"(?:^|/)shift$", path):
                return (dp_for(shape[0]), None)
            if len(shape) >= 1:
                return (dp_for(shape[0]),) + (None,) * (len(shape) - 1)
            return ()

        def walk(tree, path: str):
            if isinstance(tree, dict):
                return {k: walk(v, f"{path}/{k}" if path else k)
                        for k, v in tree.items()}
            if isinstance(tree, (list, tuple)):
                return type(tree)(walk(v, f"{path}/{i}" if path else str(i))
                                  for i, v in enumerate(tree))
            return assign(path, tree)

        return walk(caches, "")

    def splits_sequence(self, path: str, leaf) -> bool:
        """Whether :meth:`cache_shardings` splits the cache leaf at
        ``path`` (a K/V cache (B, S, H_kv, d)) along its sequence over a
        "model" axis of more than one rank (on one rank it stays whole:
        the decode kernel reads it)."""
        return (self.model_size > 1 and self.seq_shard_cache
                and bool(_KV_LEAF.search(path)) and len(leaf.shape) == 4
                and _divisible(leaf.shape[1], self.model_size))

    def logits_spec(self) -> Spec:
        v_ok = _divisible(self.cfg.vocab_size, self.model_size)
        return (_entry(self.dp_axes), None, "model" if v_ok else None)


# ---------------------------------------------------------------------------
# specs on a DeviceMesh
# ---------------------------------------------------------------------------


def _axes(entry) -> Tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: Spec, mesh) -> list:
    """A spec as one ``Shard`` / ``Replicate`` placement per mesh dim of
    ``mesh`` (a named ``DeviceMesh``).  A tensor dim split over several
    axes must name them in the mesh's order, as DTensor splits them."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh.mesh_dim_names)
    out = [Replicate() for _ in names]
    for dim, entry in enumerate(spec):
        idx = [names.index(a) for a in _axes(entry)]
        if idx != sorted(idx):
            raise ValueError(f"spec {spec}: axes of dim {dim} out of the "
                             f"mesh's order {names}")
        for i in idx:
            out[i] = Shard(dim)
    return out


def local_chunk(t: torch.Tensor, spec: Spec, mesh) -> torch.Tensor:
    """This rank's block of the whole tensor ``t`` under ``spec`` (a view,
    no communication): what ``distribute_tensor`` would leave here."""
    names = list(mesh.mesh_dim_names)
    coord = mesh.get_coordinate()
    for dim, entry in enumerate(spec):
        index, parts = 0, 1
        for a in _axes(entry):
            i = names.index(a)
            index = index * mesh.size(i) + coord[i]
            parts *= mesh.size(i)
        if parts > 1:
            size = t.shape[dim] // parts
            t = t.narrow(dim, index * size, size)
    return t


def distribute_model(model: nn.Module, policy: ShardingPolicy) -> nn.Module:
    """Replace every parameter of ``model`` (equal on every rank) by its
    ``DTensor`` laid out by ``policy`` on ``policy.mesh`` (a
    ``DeviceMesh``); in place.  The parameters do not require grad: the
    sharded train step (``runtime/steps.py``) turns it on while it runs,
    and its gradients land on them as ``DTensor``s in their layout."""
    from torch.distributed.tensor import distribute_tensor
    specs = policy.params_shardings(model)
    with torch.no_grad():
        for name, spec in specs.items():
            owner, _, leaf = name.rpartition(".")
            module = model.get_submodule(owner)
            dt = distribute_tensor(module._parameters[leaf].detach(),
                                   policy.mesh,
                                   placements(spec, policy.mesh))
            module._parameters[leaf] = nn.Parameter(dt, requires_grad=False)
    return model


def sharded_opt_state(policy: ShardingPolicy, params) -> Dict[str, Any]:
    """AdamW's state for ``params`` laid out by
    ``policy.opt_state_shardings``: float32 zero moments as ``DTensor``s
    (each rank allocates only its block) and a 0-d int32 step."""
    from torch.distributed.tensor import zeros
    mesh = policy.mesh
    specs = policy.opt_state_shardings(params)["m"]
    named = _named(params)

    def moments():
        return {n: zeros(tuple(p.shape), dtype=torch.float32,
                         device_mesh=mesh,
                         placements=placements(specs[n], mesh))
                for n, p in named.items()}

    return {"m": moments(), "v": moments(),
            "step": torch.zeros((), dtype=torch.int32,
                                device=mesh.device_type)}


def sharded_caches(policy: ShardingPolicy, caches) -> Any:
    """Zero caches of the shapes and dtypes of ``caches`` (a cache tree as
    ``models.init_cache`` gives it; meta tensors will do,
    ``models.cache_specs``) as ``DTensor``s laid out by
    ``policy.cache_shardings``: each rank allocates only its block.  What
    the sharded serve step (``runtime/steps.py``) takes."""
    from torch.distributed.tensor import zeros
    mesh = policy.mesh

    def walk(tree, spec):
        if isinstance(tree, dict):
            return {k: walk(v, spec[k]) for k, v in tree.items()}
        if isinstance(tree, list):
            return [walk(v, s) for v, s in zip(tree, spec)]
        return zeros(tuple(tree.shape), dtype=tree.dtype, device_mesh=mesh,
                     placements=placements(spec, mesh))

    return walk(caches, policy.cache_shardings(caches))
