"""Data-parallel worlds for the port: the world descriptor (``mesh``), the
symmetric heap that peers map through CUDA IPC (``symmetric_memory``), the
ring collectives over it (``overlap``) and ZeRO-3's layer-wise
parameter-gather prefetch pipeline (``prefetch``)."""
