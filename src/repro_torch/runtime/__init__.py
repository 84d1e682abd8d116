"""The training runtime (port of ``repro.runtime``): step functions, the
RSM coordinator and the trainer, and the distributed runtime on
``torch.distributed`` - the sharding policy, the hierarchical collectives
and the split-KV decode combine, the all-to-all MoE layer and the current
mesh (``runtime/compat.py``, a JAX ``shard_map`` shim, has no
counterpart)."""
