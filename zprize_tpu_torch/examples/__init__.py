"""Runnable examples of the port: `python3 -m zprize_tpu_torch.examples.<name>`."""
