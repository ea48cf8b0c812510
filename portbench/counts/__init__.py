"""Operation and byte counts of the algorithm, and the chip's peaks."""
