"""Device ops: the BM25 search kernels' wrappers and plain versions."""
