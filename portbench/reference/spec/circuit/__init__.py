"""Copied from `zprize_tpu_torch/circuit/` (see `spec/__init__.py`)."""
