"""Step builders (single device in this slice)."""
