"""Host utilities: fault injection and profiling helpers."""
