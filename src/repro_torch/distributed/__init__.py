"""Placement of the engine's slot pool over several devices.

The port of ``repro.distributed``'s slot-pool helpers (``sharding``).
The model-sharding rules of the reference (``logical_rules``,
``param_shardings``, ``batch_spec``, ``cache_seq_axes``) and its
``pp`` / ``fault`` modules wait for the training substrate (ROADMAP
queue 1 item 6).
"""
