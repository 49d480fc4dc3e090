"""The general parts of the benchmark: the cell's files by name, the
closed-loop clients, the trace reading, the roofline arithmetic."""
