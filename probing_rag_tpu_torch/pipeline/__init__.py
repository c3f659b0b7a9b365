"""The adaptive probe -> retrieve -> regenerate loop."""
