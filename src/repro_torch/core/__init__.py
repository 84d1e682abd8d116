"""Compartmentalized state machine replication on PyTorch.

The PyTorch port of :mod:`repro.core`, module for module.  It never
imports JAX nor the JAX package: the framework-free modules are carried
over as files of their own.

Correctness plane (deterministic, message-level, plain Python):
  protocols.CompartmentalizedMultiPaxos / vanilla_multipaxos /
  UnreplicatedStateMachine, mencius.MenciusDeployment,
  spaxos.SPaxosDeployment, craq.CraqDeployment, bpaxos.BPaxosDeployment,
  iss.IssDeployment + linearizability checkers; execution.run_variant
  executes any registered variant's real cluster.

Performance plane:
  api.* the variant registry and the Workload dataclass, analytical.*
  demand tables + bottleneck law for every registered variant,
  simulator.* batched MVA and fluid solves (PyTorch, float32) and the
  numpy DES, sweep.* compiled mixed-variant surfaces, transient.* the
  scripted-event schedule builders, and batched_execution.* - a whole
  (config x seed) grid of closed-loop clients in one batched device loop,
  its latency samples binned by the CUDA ``latency_hist`` kernel.

Entry points that run on a device take ``device=None``, which means
``cuda``; without a card they raise unless given ``device="cpu"``.
"""
from .api import (
    MIXED_50_50,
    READ_HEAVY,
    UNSHARDED,
    WRITE_ONLY,
    AutoscalePolicy,
    ExecutableSpec,
    GeoSpec,
    Knob,
    ShardingSpec,
    VariantSpec,
    Workload,
    as_f_write,
    executable_variants,
    knob,
    register_executable,
    register_variant,
    registered_variants,
    resolve_workload,
    temporary_variants,
    unregister_variant,
    variant_spec,
)
from .analytical import (
    STATION_ORDER,
    VARIANT_MODELS,
    DeploymentModel,
    Station,
    ablation_steps,
    calibrate_alpha,
    compartmentalized_model,
    craq_chain_model,
    craq_model,
    craq_station_demands,
    effective_batch_size,
    grids_under,
    mencius_model,
    mixed_workload_speedup,
    multipaxos_model,
    read_scalability_law,
    spaxos_model,
    stack_demands,
    unreplicated_model,
    vanilla_mencius_model,
    vanilla_spaxos_model,
)
from .batched_execution import (
    BatchedExecutionResult,
    BatchedParityReport,
    LaneInputs,
    execute_configs,
    lane_inputs_from_numpy,
    measured_capacity,
    run_variant_batched,
    validate_batched,
)
from .bpaxos import BPaxosDeployment, bpaxos_model
from .cluster import Network, Node
from .craq import CraqDeployment
from .execution import (
    AutoscaledExecutionTrace,
    ExecutionTrace,
    ParityReport,
    ShardedDeployment,
    ShardedExecutionTrace,
    ShardedParityReport,
    StationParity,
    default_config,
    resizable_stations,
    resize_config,
    run_autoscaled,
    run_sharded,
    run_variant,
    station_knob_map,
    validate_sharded,
    validate_variant,
    workload_ops,
)
from .geo import (
    GeoLatency,
    geo_station_kinds,
    geo_variants,
    placement_candidates,
    predict_geo_latency,
    register_geo_path,
    wan_offsets,
    zero_rtt,
)
from .history import History, Operation
from .iss import IssDeployment, iss_model
from .linearizability import (
    check_linearizable,
    check_register_reads,
    check_slot_order,
)
from .mencius import MenciusDeployment
from .messages import Command, noop_command
from .sharding import (
    check_linearizable_partitioned,
    flatten_shards,
    partition_history,
    partition_ops,
    shard_column,
    shard_demands,
    shard_weights,
    split_counts,
    split_weights,
)
from .protocols import (
    CompartmentalizedMultiPaxos,
    DeploymentConfig,
    UnreplicatedStateMachine,
    full_compartmentalized,
    vanilla_multipaxos,
)
from .device import resolve_device
from .quorums import GridQuorums, MajorityQuorums
from .simulator import (
    des_throughput,
    fluid_throughput,
    fluid_throughput_batch,
    mva_curve,
    mva_curves_batch,
    mva_curves_from_demands,
)
from .spaxos import SPaxosDeployment
from .sweep import (
    CompiledSweep,
    GeoLatencySurface,
    SweepSpec,
    compile_models,
    compile_sweep,
    config_variant,
    model_for,
)
from .transient import (
    CRASH,
    Event,
    build_schedule,
    burst_events,
    failover_schedule,
    mencius_skip_storm_schedule,
    reconfiguration_schedule,
    region_partition_schedule,
    resharding_schedule,
    scale_schedule,
    schedule_from_demands,
    spaxos_payload_ramp_schedule,
)
from .statemachine import AppendLog, KVStore, Register, make_state_machine

__all__ = [
    "MIXED_50_50", "READ_HEAVY", "UNSHARDED", "WRITE_ONLY",
    "AppendLog", "AutoscalePolicy", "AutoscaledExecutionTrace",
    "BPaxosDeployment", "BatchedExecutionResult", "BatchedParityReport",
    "CRASH", "Command", "CompartmentalizedMultiPaxos", "CompiledSweep",
    "CraqDeployment", "DeploymentConfig", "DeploymentModel", "Event",
    "ExecutableSpec", "ExecutionTrace", "GeoLatency", "GeoLatencySurface",
    "GeoSpec", "GridQuorums", "History", "IssDeployment", "KVStore", "Knob",
    "LaneInputs", "MajorityQuorums", "MenciusDeployment", "Network", "Node",
    "Operation", "ParityReport", "Register", "SPaxosDeployment",
    "STATION_ORDER", "ShardedDeployment", "ShardedExecutionTrace",
    "ShardedParityReport", "ShardingSpec", "Station", "StationParity",
    "SweepSpec", "UnreplicatedStateMachine", "VARIANT_MODELS",
    "VariantSpec", "Workload",
    "ablation_steps", "as_f_write", "bpaxos_model", "build_schedule",
    "burst_events", "calibrate_alpha", "check_linearizable",
    "check_linearizable_partitioned", "check_register_reads",
    "check_slot_order", "compartmentalized_model", "compile_models",
    "compile_sweep", "config_variant", "craq_chain_model", "craq_model",
    "craq_station_demands", "default_config", "des_throughput",
    "effective_batch_size", "executable_variants", "execute_configs",
    "failover_schedule", "flatten_shards", "fluid_throughput",
    "fluid_throughput_batch", "full_compartmentalized", "geo_station_kinds",
    "geo_variants", "grids_under", "iss_model", "knob",
    "lane_inputs_from_numpy", "make_state_machine", "measured_capacity",
    "mencius_model", "mencius_skip_storm_schedule", "mixed_workload_speedup",
    "model_for", "multipaxos_model", "mva_curve", "mva_curves_batch",
    "mva_curves_from_demands", "noop_command", "partition_history",
    "partition_ops", "placement_candidates", "predict_geo_latency",
    "read_scalability_law", "reconfiguration_schedule",
    "register_executable", "register_geo_path", "register_variant",
    "registered_variants", "region_partition_schedule",
    "resharding_schedule", "resizable_stations", "resize_config",
    "resolve_device", "resolve_workload", "run_autoscaled", "run_sharded",
    "run_variant", "run_variant_batched", "scale_schedule",
    "schedule_from_demands", "shard_column", "shard_demands",
    "shard_weights", "spaxos_model", "spaxos_payload_ramp_schedule",
    "split_counts", "split_weights", "stack_demands", "station_knob_map",
    "temporary_variants", "unregister_variant", "unreplicated_model",
    "validate_batched", "validate_sharded", "validate_variant",
    "vanilla_mencius_model", "vanilla_multipaxos", "vanilla_spaxos_model",
    "variant_spec", "wan_offsets", "workload_ops", "zero_rtt",
]
