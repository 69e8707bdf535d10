"""Placement over several devices, pipelining, and the trainer's fault
handling.

The port of ``repro.distributed``: ``mesh`` (the process mesh the LM
is sharded over), ``sharding`` (the model-sharding rules, the
placements and collectives that realize them over a process mesh, and
the slot pool's placement over a host mesh), ``pp`` (GPipe over a
``"stage"`` axis) and ``fault`` (restart supervision, preemption
capture, heartbeats, straggler detection).
"""
