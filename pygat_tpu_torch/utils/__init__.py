"""Host-side helpers (padding, device and generator selection)."""
