"""Host-side fault tolerance of the LM stack, as ``repro.distributed``:
``ft`` (heartbeats and the straggler monitor).  ``sharding`` and
``compression`` come with ROADMAP 1.14.5."""
