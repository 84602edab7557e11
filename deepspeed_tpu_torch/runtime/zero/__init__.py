"""ZeRO for the port: the stage-3 shard specs (``partition``) and the
offload tiers (``offload_stream``, ``offload``, ``pinned``,
``contiguous_memory_allocator``)."""
