"""One module per kind of job a traffic mix names (its ``job`` key)."""
