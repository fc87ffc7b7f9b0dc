"""Copied from `zprize_tpu_torch/ref/` (see `spec/__init__.py`)."""
