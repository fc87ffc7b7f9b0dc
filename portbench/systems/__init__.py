"""The systems under test: one module a kind of configuration, named by the
configuration file's "system" key, with the set-up that `window.py` runs
(`setup`) and the hooks that break it (`HOOKS`, its control `CONTROL`)."""
