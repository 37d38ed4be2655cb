"""Detection, fault injection and the serving recovery policy."""
