"""The LM stack's distributed parts, as ``repro.distributed``: ``ft``
(heartbeats and the straggler monitor), ``sharding`` (logical-axis rules
over DeviceMesh and DTensor) and ``compression`` (int8 gradient reduce
with error feedback)."""
