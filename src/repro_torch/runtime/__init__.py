"""The single-process training runtime: step functions, the RSM
coordinator and the trainer (port of ``repro.runtime``; the distributed
runtime is ``ROADMAP.md`` queue 1, item 6)."""
