"""The harness: what every cell shares, and never edited for a new cell."""
