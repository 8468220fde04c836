"""Host-side utilities (metrics logging, timing)."""
