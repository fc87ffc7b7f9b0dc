"""Each system's seeded inputs, `recipes/<system>.py`, named by the
configuration file's "system" key: what the run hands its program and what
the reference `reference/<system>.py` makes again from the same seed.
Plain Python and numpy."""
