"""Traffic drivers, one module each, named by a mix's ``driver`` key."""
