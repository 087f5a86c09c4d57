"""Host-side utilities: running meters."""
