"""Data: tokenizer, corpus reading and the seeded split, training batches
and their loader, padded and packed serving batches."""
