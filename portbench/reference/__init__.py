"""The plain reference that judges a run: plain Python and numpy, with
no torch, no port and no JAX (see `check.py`)."""
