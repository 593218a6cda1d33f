"""Host protocol core (numpy): masking configuration, objects, PRNG."""
