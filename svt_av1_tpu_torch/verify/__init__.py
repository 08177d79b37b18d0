"""Independent conformance verification (no shared prediction code)."""
