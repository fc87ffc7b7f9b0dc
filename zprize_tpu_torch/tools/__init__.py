"""Measuring tools of the port on the card:
`python3 -m zprize_tpu_torch.tools.<name>`."""
