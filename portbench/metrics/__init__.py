"""One file a metric, found by its name (see `portbench/harness.py`)."""
