"""Copied from `zprize_tpu_torch/transcript/` (see `spec/__init__.py`)."""
