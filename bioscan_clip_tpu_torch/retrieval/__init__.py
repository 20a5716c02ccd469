"""Exact top-k retrieval and the serving service."""
