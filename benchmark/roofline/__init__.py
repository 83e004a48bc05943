"""Roofline arithmetic, one file a kernel family, over the peaks table
(peaks.py). Frozen with the benchmark: the program cannot move it."""
