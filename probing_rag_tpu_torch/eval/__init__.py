"""Host-side evaluation: metrics, answer extraction, run records (copies
of ``probing_rag_tpu/eval``)."""
