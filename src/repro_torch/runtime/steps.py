"""Step functions (train / prefill / serve) and dry-run input specs (port
of ``runtime/steps.py``).

The reference's steps close over the static ModelConfig and are jitted;
here they run eagerly.  The train step differentiates ``loss_fn`` with
autograd - on the card through the hand-written attention backward - and
applies AdamW in place.  The prefill and serve steps run under
``torch.inference_mode()``.  Given a ``ShardingPolicy`` on a
``DeviceMesh``, each step runs on every rank over parameters laid out by
it, gathered at use (the reference gets these programs from XLA's
partitioner, ``jax.jit`` with ``in_shardings``; the port writes them
out).  The spec functions give tensors on ``torch.device("meta")``:
shapes and dtypes, nothing allocated.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional

import torch

from ..configs.base import ModelConfig
from ..configs.shapes import ShapeSpec
from ..models import model as model_lib
from ..models.convert import decay_mask
from ..models.moe import MoE
from ..optim.adamw import AdamWConfig, adamw_update, init_opt_state

_META = torch.device("meta")


def make_train_step(cfg: ModelConfig, opt_cfg: Optional[AdamWConfig] = None,
                    policy=None):
    """``train_step(params, opt_state, batch) -> (params, opt_state,
    metrics)``: one forward and backward of ``loss_fn`` over ``params`` (a
    :class:`~repro_torch.models.Transformer` whose parameters require
    grad), then AdamW (decaying what the reference decays: ``decay_mask``),
    which writes the parameters and moments in place.
    ``metrics``: "loss", "ce", "aux", "grad_norm", "lr" as 0-d tensors.

    With a :class:`~repro_torch.runtime.sharding.ShardingPolicy` on a
    ``DeviceMesh``, the step runs on every rank of the mesh over
    parameters and moments laid out by it (``sharding.distribute_model``,
    ``sharding.sharded_opt_state``) and the whole batch: see
    :func:`_sharded_train_step`."""
    opt_cfg = opt_cfg or AdamWConfig()
    if policy is not None:
        return _sharded_train_step(cfg, opt_cfg, policy)

    def train_step(params, opt_state, batch):
        for p in params.parameters():
            p.grad = None
        loss, metrics = model_lib.loss_fn(cfg, params, batch)
        loss.backward()
        named = dict(params.named_parameters())
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p)
                 for n, p in named.items()}
        _, new_opt, opt_metrics = adamw_update(opt_cfg, grads, opt_state,
                                               named, decay_mask(params))
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(opt_metrics)
        return params, new_opt, metrics

    return train_step


def _gather_units(model: torch.nn.Module):
    """The modules that gather their parameters as they are called: the
    model itself for its own (embedding, final norms: every parameter
    outside a layer), then each decoder and encoder layer for its own."""
    layers = [m for name in ("layers", "encoder") if hasattr(model, name)
              for m in getattr(model, name)]
    inner = {id(p) for layer in layers for p in layer.parameters()}
    own = [n for n, p in model.named_parameters() if id(p) not in inner]
    return [(model, own)] + [(layer, [n for n, _ in layer.named_parameters()])
                             for layer in layers]


@contextlib.contextmanager
def _gathered_at_use(model: torch.nn.Module, grad_placements=None):
    """Inside the block, each unit of :func:`_gather_units` replaces its
    ``DTensor`` parameters by their ``full_tensor()`` for the length of
    each call of its ``forward`` or ``decode`` (the entries the steps go
    through) and puts them back after it, so a layer's whole weights live
    only while it runs (and while a remat layer is recomputed in the
    backward, which calls it again).  ``grad_placements``: {id of a
    parameter: the placements of the gradient of its whole copy}, which
    the backward turns into the parameter's own layout (``Partial`` over
    a mesh dim: summed there); None where no gradient is taken."""
    def gathering(module, names, entry):
        def call(*args, **kwargs):
            slots = []
            try:
                for name in names:
                    owner, _, leaf = name.rpartition(".")
                    sub = module.get_submodule(owner)
                    p = sub._parameters[leaf]
                    slots.append((sub, leaf, p))
                    sub._parameters[leaf] = p.full_tensor(
                        grad_placements=None if grad_placements is None
                        else grad_placements[id(p)])
                return entry(*args, **kwargs)
            finally:
                for sub, leaf, p in slots:
                    sub._parameters[leaf] = p
        return call

    wrapped = []
    for module, names in _gather_units(model):
        for entry in ("forward", "decode"):
            if hasattr(module, entry):
                setattr(module, entry,
                        gathering(module, names, getattr(module, entry)))
                wrapped.append((module, entry))
    try:
        yield model
    finally:
        for module, entry in wrapped:
            delattr(module, entry)  # the class's method again


def _a2a_over_model(cfg: ModelConfig, policy) -> bool:
    """Whether the model's MoE layers run the all-to-all layer over a
    model axis of more than one rank.  That layer splits the rows it is
    given over the model axis itself, so it takes a batch split over the
    data axes only: with a lever that splits the batch over "model" too
    (``dp_only``, ``fsdp``) it raises."""
    if cfg.moe is None or cfg.moe_impl != "a2a" or policy.model_size == 1:
        return False
    if "model" in policy.dp_axes:
        raise NotImplementedError(
            "moe_impl='a2a' splits its rows over the model axis itself and "
            "does not take a batch split there (dp_only, fsdp)")
    return True


def _local_rows(policy, batch: Dict[str, torch.Tensor]):
    """(this rank's rows of each batch entry, the mesh axes the batch is
    split over): whole sequences (``seq_dp``'s split of the sequence is
    the reference's layout for XLA to gather across, and is not taken
    here: the ranks it would split hold the same rows)."""
    from .sharding import _axes, local_chunk
    b_specs = {k: spec[:1] for k, spec in
               policy.batch_shardings(batch).items()}
    local = {k: local_chunk(v, b_specs[k], policy.mesh)
             for k, v in batch.items()}
    return local, _axes(b_specs["tokens"][0])


def _sharded_train_step(cfg: ModelConfig, opt_cfg: AdamWConfig, policy):
    """The train step on parameters and moments laid out by ``policy`` on
    its ``DeviceMesh``, run by every rank; equal to the unsharded step on
    the whole batch up to the order of float sums.

    The parameters are gathered at use, layer by layer
    (:func:`_gathered_at_use`, the ``fsdp`` lever's pattern): each
    layer's ``DTensor`` parameters become their ``full_tensor()`` while
    it runs, so the attention kernels' wrappers and every other op see
    plain tensors, never a ``DTensor`` (no op of the model then needs a
    ``DTensor`` rule), and one layer's whole weights are held at a time
    (with remat, the backward's recompute gathers them again; the model's
    own parameters - embedding, final norm - are held through the
    forward).  Each rank takes its rows of the batch (the policy's batch
    spec).  A whole copy's gradient is ``Partial`` over the mesh dims the
    batch is split on and ``Replicate`` over the others (their ranks
    compute the same gradient), so the backward reduces it into the
    parameter's layout as each layer's completes: a reduce-scatter where
    the parameter is sharded over a batch dim, an all-reduce where it is
    replicated there, a local slice elsewhere.  With ``moe_impl="a2a"``
    over a model axis of more than one rank the MoE layers' parameters
    are ``Partial`` over "model" too: the layer splits its rows over that
    axis (``runtime/moe_a2a.py``), so each rank's router and shared
    experts see only its rows, and its experts only the tokens routed to
    them (the other ranks hold zeros for them), and the backward sums
    them there - a reduce-scatter into the experts' shards, an all-reduce
    for the replicated router and shared experts.  The loss is the whole
    batch's on every rank, as the reference's one SPMD program computes
    it: the model runs under ``use_mesh`` with the batch's axes, so the
    cross-entropy and the load-balance loss take their sums and counts
    over the batch's ranks before they divide or multiply
    (``mesh_context.whole_batch_sum``), with the gradient of the rank's
    own rows; the ranks' gradients summed are then the whole batch's, and
    nothing is divided or averaged after.  AdamW then updates each rank's
    blocks in the moments' layout (ZeRO-1: a block of the data axis too), from
    the whole gradient's global norm, and the new blocks go back to the
    parameters' layout (an all-gather over "data" under ZeRO-1).  The
    gradients land on the parameters, which require grad through the
    step only, and are dropped after it.  The metrics are the whole
    batch's on every rank (the a2a layer's load-balance loss is its mean
    over the batch's and the model's ranks, the reference's estimator)."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    from .mesh_context import use_mesh
    from .sharding import placements

    mesh = policy.mesh
    names = list(mesh.mesh_dim_names)
    a2a = _a2a_over_model(cfg, policy)

    def train_step(params, opt_state, batch):
        named = dict(params.named_parameters())
        trainable = {n: p.requires_grad for n, p in named.items()}
        for p in named.values():
            p.requires_grad_(True)
            p.grad = None
        local, batch_axes = _local_rows(policy, batch)
        n_batch = 1
        for a in batch_axes:
            n_batch *= mesh.size(names.index(a))
        # a whole copy's gradient is partial over the batch's axes, and
        # over "model" too for the a2a layers' parameters
        moe = {id(p) for sub in params.modules() if a2a
               and isinstance(sub, MoE) for p in sub.parameters()}
        grad_pl = {id(p): [Partial() if a in batch_axes or (
            a == "model" and id(p) in moe) else Replicate() for a in names]
            for p in named.values()}
        # the losses take their sums over the batch's ranks: each rank's
        # loss and metrics are the whole batch's, and the sum of the
        # ranks' gradients is its gradient
        with _gathered_at_use(params, grad_pl), use_mesh(
                mesh, batch_axes if n_batch > 1 else ()):
            loss, metrics = model_lib.loss_fn(cfg, params, local)
            loss.backward()
        with torch.no_grad():
            grads = {n: p.grad if p.grad is not None
                     else torch.zeros_like(p) for n, p in named.items()}
            norm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                                  .full_tensor() for g in grads.values()))
        m_specs = policy.opt_state_shardings(params)["m"]
        m_pl = {n: placements(m_specs[n], mesh) for n in named}
        # written in place by AdamW (where a block is a view of the
        # parameter, that writes the parameter too, with the same values
        # the gather below writes)
        blocks = {n: p.detach().redistribute(mesh, m_pl[n]).to_local()
                  for n, p in named.items()}
        local_state = {
            "m": {n: m.to_local() for n, m in opt_state["m"].items()},
            "v": {n: v.to_local() for n, v in opt_state["v"].items()},
            "step": opt_state["step"]}
        _, local_state, opt_metrics = adamw_update(
            opt_cfg, {n: g.redistribute(mesh, m_pl[n]).to_local()
                      for n, g in grads.items()},
            local_state, blocks, decay_mask(params), grad_norm=norm)
        with torch.no_grad():
            for n, p in named.items():
                p.grad = None
                p.requires_grad_(trainable[n])
                new = DTensor.from_local(
                    blocks[n], mesh, m_pl[n],
                    run_check=False).redistribute(mesh, p.placements)
                p.to_local().copy_(new.to_local())
        opt_state["step"] = local_state["step"]
        metrics = {k: v.detach() for k, v in metrics.items()}
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig, policy=None):
    """``prefill_step(params, batch) -> (last logits, caches)``: the model
    over ``batch["tokens"]`` (and "frames"), its caches sized to the
    prompt.

    With a :class:`~repro_torch.runtime.sharding.ShardingPolicy` on a
    ``DeviceMesh`` it runs on every rank: ``params`` laid out by it
    (``sharding.distribute_model``) and gathered at use, layer by layer,
    as the sharded train step gathers them; ``batch`` whole on every rank,
    of which each rank runs its rows (the policy's batch spec).  It
    returns the rank's rows of the logits and the caches as ``DTensor``s
    in ``policy.cache_shardings``' layout (a K/V cache's sequence split
    over "model", a recurrent state's channels or heads where they
    divide): what :func:`make_serve_step` takes."""
    if policy is not None:
        return _sharded_prefill_step(cfg, policy)

    @torch.inference_mode()
    def prefill_step(params, batch):
        return model_lib.prefill(cfg, params, batch["tokens"],
                                 frames=batch.get("frames"),
                                 cache_len=batch["tokens"].shape[1])
    return prefill_step


def make_serve_step(cfg: ModelConfig, policy=None):
    """One decode step: greedy next token against a filled KV cache.
    ``serve_step(params, caches, token) -> (next token, logits, caches)``.

    With a policy on a ``DeviceMesh``: ``params`` laid out by it and
    gathered at use, ``caches`` ``DTensor``s in ``policy.
    cache_shardings``' layout (as :func:`make_prefill_step` returns them,
    or ``sharding.sharded_caches``), ``token`` (B, 1) whole on every rank;
    each rank runs its rows.  A K/V cache split along its sequence over
    "model" stays split: each rank writes the new row where it owns it and
    attends over its own rows, and the split-KV combine
    (``collectives.make_distributed_flash_decode``) merges the ranks'
    partials - one max and two sums of O(B H d) instead of gathering the
    cache.  A recurrent state split over "model" is gathered for the step
    and split again after it.  Returns the rank's rows of the next token
    and the logits, and the caches in their layout (K/V written in
    place)."""
    if policy is not None:
        return _sharded_serve_step(cfg, policy)

    @torch.inference_mode()
    def serve_step(params, caches, token):
        logits, new_caches = model_lib.decode_step(cfg, params, caches, token)
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return next_token, logits, new_caches

    return serve_step


def _tree_map(fn, tree, *rest, path: str = ""):
    """``fn(path, leaf, *leaves of rest)`` over a cache tree (dicts and
    lists; a tuple is a leaf: a spec), keeping its structure."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, *(r[k] for r in rest),
                             path=f"{path}/{k}" if path else k)
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_tree_map(fn, v, *(r[i] for r in rest),
                          path=f"{path}/{i}" if path else str(i))
                for i, v in enumerate(tree)]
    return fn(path, tree, *rest)


def _batch_only(pl) -> list:
    """The placements with every split but the batch's (dim 0) dropped."""
    from torch.distributed.tensor import Replicate
    return [p if p.is_shard() and p.dim == 0 else Replicate() for p in pl]


def _strides(shape) -> tuple:
    out, step = [], 1
    for n in reversed(tuple(shape)):
        out.append(step)
        step *= n
    return tuple(reversed(out))


def _sharded_prefill_step(cfg: ModelConfig, policy):
    from torch.distributed.tensor import DTensor

    from .mesh_context import use_mesh
    from .sharding import placements

    mesh = policy.mesh

    @torch.inference_mode()
    def prefill_step(params, batch):
        local, _ = _local_rows(policy, batch)
        B = batch["tokens"].shape[0]
        with _gathered_at_use(params), use_mesh(mesh):
            logits, caches = model_lib.prefill(
                cfg, params, local["tokens"], frames=local.get("frames"),
                cache_len=local["tokens"].shape[1])

        def whole(path, t):  # the whole cache's shape: all the batch
            return (B,) + tuple(t.shape[1:]) if t.dim() else ()

        specs = policy.cache_shardings(_tree_map(
            lambda path, t: torch.empty(whole(path, t), dtype=t.dtype,
                                        device="meta"), caches))

        def lay_out(path, t, spec):
            # the rank's rows, whole along every other dim, to the
            # layout's blocks: a local slice, no exchange
            pl = placements(spec, mesh)
            shape = whole(path, t)
            rows = DTensor.from_local(t, mesh, _batch_only(pl),
                                      run_check=False, shape=shape,
                                      stride=_strides(shape))
            return rows.redistribute(mesh, pl)

        return logits, _tree_map(lay_out, caches, specs)

    return prefill_step


def _sharded_serve_step(cfg: ModelConfig, policy):
    from torch.distributed.tensor import DTensor, Shard

    from .mesh_context import use_mesh
    from .sharding import local_chunk

    mesh = policy.mesh

    @torch.inference_mode()
    def serve_step(params, caches, token):
        t_spec = policy.batch_shardings({"token": token})["token"][:1]
        tok = local_chunk(token, t_spec, mesh)

        def to_local(path, t):
            if policy.splits_sequence(path, t):
                # the rank's rows of the batch and its block of the
                # sequence (a view: the step writes it in place), as a
                # DTensor split over "model" alone
                block = t.to_local()
                shape = (block.shape[0], t.shape[1]) + tuple(block.shape[2:])
                return DTensor.from_local(block, mesh["model"], [Shard(1)],
                                          run_check=False, shape=shape,
                                          stride=_strides(shape))
            rows = _batch_only(t.placements)
            if list(rows) != list(t.placements):  # gathered for the step
                t = t.redistribute(mesh, rows)
            return t.to_local()

        local = _tree_map(to_local, caches)
        with _gathered_at_use(params), use_mesh(mesh):
            logits, new = model_lib.decode_step(cfg, params, local, tok)

        def lay_out(path, t, old):
            if isinstance(t, DTensor):
                return old            # written in place
            rows = DTensor.from_local(t, mesh, _batch_only(old.placements),
                                      run_check=False, shape=old.shape,
                                      stride=old.stride())
            return rows.redistribute(mesh, old.placements)

        next_token = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return next_token, logits, _tree_map(lay_out, new, caches)

    return serve_step


# ---------------------------------------------------------------------------
# dry-run input specs (meta tensors; no allocation)
# ---------------------------------------------------------------------------


def batch_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    B, S = shape.global_batch, shape.seq_len
    specs = {
        "tokens": torch.empty((B, S), dtype=torch.int32, device=_META),
        "labels": torch.empty((B, S), dtype=torch.int32, device=_META),
    }
    if cfg.is_encoder_decoder:
        # modality frontend stub: precomputed frame embeddings
        specs["frames"] = torch.empty(
            (B, cfg.encoder_seq_len, cfg.d_model), dtype=cfg.cdtype(),
            device=_META)
    return specs


def params_specs(cfg: ModelConfig) -> model_lib.Transformer:
    return model_lib.Transformer(cfg, None, _META)


def opt_state_specs(params) -> Dict[str, Any]:
    return init_opt_state(params)


def cache_specs(cfg: ModelConfig, batch: int, cache_len: int):
    return model_lib.cache_specs(cfg, batch, cache_len)


def input_specs(cfg: ModelConfig, shape: ShapeSpec) -> Dict[str, Any]:
    """Every model input for the given cell, as meta tensors."""
    if shape.kind == "train":
        p = params_specs(cfg)
        return {
            "params": p,
            "opt_state": opt_state_specs(p),
            "batch": batch_specs(cfg, shape),
        }
    if shape.kind == "prefill":
        return {
            "params": params_specs(cfg),
            "batch": batch_specs(cfg, shape),
        }
    if shape.kind == "decode":
        return {
            "params": params_specs(cfg),
            "caches": cache_specs(cfg, shape.global_batch, shape.seq_len),
            "token": torch.empty((shape.global_batch, 1), dtype=torch.int32,
                                 device=_META),
        }
    raise ValueError(shape.kind)
