"""Device-resident aggregation (one device)."""
