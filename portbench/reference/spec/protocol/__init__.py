"""Copied from `zprize_tpu_torch/protocol/` (see `spec/__init__.py`)."""
