"""Grid-quorum checkpoints of torch tensors (port of ``repro.checkpoint``)."""
