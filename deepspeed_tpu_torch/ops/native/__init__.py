"""Host libraries built with g++ at first use: the SIMD CPU Adam
(``cpu_adam``) and the async I/O handle (``aio``)."""
