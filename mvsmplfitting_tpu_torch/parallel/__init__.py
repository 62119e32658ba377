"""Frame batches on one card."""
