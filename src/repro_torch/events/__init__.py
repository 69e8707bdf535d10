"""Host event streams: synthetic scenes, AER packing, padded batches."""
