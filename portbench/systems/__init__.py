"""The systems under test: one module a kind of configuration, named by the
configuration file's "system" key."""
