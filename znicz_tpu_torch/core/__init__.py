"""Host-side core: config tree, named PRNG registry, device selection."""
