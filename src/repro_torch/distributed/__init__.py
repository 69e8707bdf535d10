"""Placement of the engine's slot pool over several devices, and the
trainer's fault handling.

The port of ``repro.distributed``'s slot-pool helpers (``sharding``) and
of ``fault`` (restart supervision, preemption capture, heartbeats,
straggler detection).  The model-sharding rules of the reference
(``logical_rules``, ``param_shardings``, ``batch_spec``,
``cache_seq_axes``) and its ``pp`` module wait for model sharding
(ROADMAP queue 1).
"""
