"""Data: tokenizer, corpus reading, padded and packed serving batches."""
