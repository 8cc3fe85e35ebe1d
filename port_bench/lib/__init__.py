"""The harness: cells, traffic, windows, traces and the output check."""
