"""The harness: the cell spec, traffic, the systems, the window, the check, the trace."""
