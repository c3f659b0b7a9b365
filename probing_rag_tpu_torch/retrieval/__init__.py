"""BM25 index and search."""
