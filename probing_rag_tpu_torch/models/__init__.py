"""Gemma-architecture LM, tokenizer, greedy decode, dense text encoder."""
