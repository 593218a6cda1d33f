"""Device-resident aggregation: one device, a mesh of devices (one shard
each), or several processes (``multihost``)."""
