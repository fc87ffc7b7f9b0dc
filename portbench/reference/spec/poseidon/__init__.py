"""Copied from `zprize_tpu_torch/poseidon/` (see `spec/__init__.py`)."""
