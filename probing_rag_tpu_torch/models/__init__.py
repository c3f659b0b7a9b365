"""Gemma-architecture LM, tokenizer, greedy decode."""
