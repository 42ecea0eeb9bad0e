"""Host-side helpers (numpy)."""
