"""Step functions (train / prefill / serve) and dry-run input specs (port
of ``runtime/steps.py``).

The reference's steps close over the static ModelConfig and are jitted;
here they run eagerly.  The train step differentiates ``loss_fn`` with
autograd - on the card through the hand-written attention backward - and
applies AdamW in place.  The prefill and serve steps run under
``torch.inference_mode()``.  The spec functions give tensors on
``torch.device("meta")``: shapes and dtypes, nothing allocated.
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional

import torch

from ..configs.base import ModelConfig
from ..configs.shapes import ShapeSpec
from ..models import model as model_lib
from ..models.convert import decay_mask
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
def _gathered_at_use(model: torch.nn.Module, grad_placements):
    """Inside the block, each unit of :func:`_gather_units` replaces its
    ``DTensor`` parameters by their ``full_tensor()`` when it is called
    and puts them back when it returns, so a layer's whole weights live
    only while it runs (and while a remat layer is recomputed in the
    backward, which gathers them again).  ``grad_placements``: the
    placements of the gradient of a whole copy, which the backward turns
    into the parameter's own layout (``Partial`` over a mesh dim: summed
    there)."""
    stacks, handles = {}, []

    def gather(names):
        def hook(module, args):
            slots = []
            for name in names:
                owner, _, leaf = name.rpartition(".")
                sub = module.get_submodule(owner)
                p = sub._parameters[leaf]
                slots.append((sub, leaf, p))
                sub._parameters[leaf] = p.full_tensor(
                    grad_placements=grad_placements)
            stacks.setdefault(id(module), []).append(slots)
        return hook

    def restore(module, args, out):
        for sub, leaf, p in stacks[id(module)].pop():
            sub._parameters[leaf] = p

    for module, names in _gather_units(model):
        handles.append(module.register_forward_pre_hook(gather(names)))
        handles.append(module.register_forward_hook(restore))
    try:
        yield model
    finally:
        for h in handles:
            h.remove()
        for left in stacks.values():  # a forward that raised
            for slots in left:
                for sub, leaf, p in slots:
                    sub._parameters[leaf] = p


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
    replicated there, a local slice elsewhere.  The sum is divided by the
    batch's ranks.  AdamW then updates each rank's blocks in the moments'
    layout (ZeRO-1: a block of the data axis too), from the whole
    gradient's global norm, and the new blocks go back to the parameters'
    layout (an all-gather over "data" under ZeRO-1).  The gradients land
    on the parameters, which require grad through the step only, and are
    dropped after it."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    from torch.utils.checkpoint import set_checkpoint_early_stop

    from .collectives import mean_over
    from .sharding import _axes, local_chunk, placements

    mesh = policy.mesh
    names = list(mesh.mesh_dim_names)
    if cfg.moe is not None and cfg.moe_impl == "a2a" \
            and policy.model_size > 1:
        raise NotImplementedError(
            "the sharded train step does not sum the a2a MoE layer's "
            "gradients over the model axis")

    def train_step(params, opt_state, batch):
        named = dict(params.named_parameters())
        trainable = {n: p.requires_grad for n, p in named.items()}
        for p in named.values():
            p.requires_grad_(True)
            p.grad = None
        # each rank's rows; whole sequences (``seq_dp``'s split of the
        # sequence is the reference's layout for XLA to gather across, and
        # is not taken here: the ranks it would split hold the same rows)
        b_specs = {k: spec[:1] for k, spec in
                   policy.batch_shardings(batch).items()}
        local = {k: local_chunk(v, b_specs[k], mesh)
                 for k, v in batch.items()}
        batch_axes = _axes(b_specs["tokens"][0])
        n_batch = 1
        for a in batch_axes:
            n_batch *= mesh.size(names.index(a))
        grad_pl = [Partial() if a in batch_axes else Replicate()
                   for a in names]
        # a remat layer's recompute runs to its end (no early stop), so
        # that its forward hook puts its parameters back
        with _gathered_at_use(params, grad_pl), set_checkpoint_early_stop(
                False):
            loss, metrics = model_lib.loss_fn(cfg, params, local)
            loss.backward()
        with torch.no_grad():
            grads = {n: p.grad.div_(n_batch) if p.grad is not None
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
        metrics = {k: mean_over(v.detach().clone(), mesh, batch_axes)
                   for k, v in metrics.items()}
        metrics.update(opt_metrics)
        return params, opt_state, metrics

    return train_step


def make_prefill_step(cfg: ModelConfig):
    @torch.inference_mode()
    def prefill_step(params, batch):
        return model_lib.prefill(cfg, params, batch["tokens"],
                                 frames=batch.get("frames"),
                                 cache_len=batch["tokens"].shape[1])
    return prefill_step


def make_serve_step(cfg: ModelConfig):
    """One decode step: greedy next token against a filled KV cache."""

    @torch.inference_mode()
    def serve_step(params, caches, token):
        logits, new_caches = model_lib.decode_step(cfg, params, caches, token)
        next_token = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        return next_token, logits, new_caches

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
