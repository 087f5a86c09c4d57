"""Input conversion."""
