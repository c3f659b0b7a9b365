"""BM25, flat dense and IVF indexes and search."""
