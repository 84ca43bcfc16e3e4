"""Data loaders (port of ``znicz_tpu/loader``): split bookkeeping,
shuffling from the named PRNG stream, fixed-shape masked minibatches."""
