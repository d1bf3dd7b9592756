"""The harness: finding cells, configurations and metrics by name, the
closed loop, the device trace, and the result line."""
