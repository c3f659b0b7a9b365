"""Host-side data: prompts, QA loaders, corpus readers (copies of
``probing_rag_tpu/data``)."""
