"""Citation datasets, preprocessing and deterministic synthetic stand-ins."""
