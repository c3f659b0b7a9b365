"""Prober MLPs and the ensemble retrieval gate."""
