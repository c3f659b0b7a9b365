"""Device ops: the BM25, flat dense and IVF search kernels' wrappers and
their plain versions."""
