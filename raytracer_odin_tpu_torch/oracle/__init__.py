"""Independent numpy reference renderer (the oracle)."""
