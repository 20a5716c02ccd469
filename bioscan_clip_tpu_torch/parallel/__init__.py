"""One data axis over processes or devices, and the process group."""
