"""ZeRO for the port: the stage-3 shard specs (``partition``)."""
