"""The benchmark's reference: a FLAC reader and raster generators in plain
NumPy and PyTorch.  It imports nothing of the program under test."""
