"""Run-time utilities (logging)."""
