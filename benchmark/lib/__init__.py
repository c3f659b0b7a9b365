"""The benchmark's shared machinery: manifest, spans, trace, data."""
