"""Measuring tools of the port on the card, and the multi-process dry run
of the meshed primitives on the CPU:
`python3 -m zprize_tpu_torch.tools.<name>`."""
