"""Host ChaCha20 keystream and the rejection sampler (numpy)."""
