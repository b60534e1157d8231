"""Step factories of the port (serving steps only so far)."""
