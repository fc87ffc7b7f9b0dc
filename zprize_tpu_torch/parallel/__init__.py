"""Multi-rank proving over `torch.distributed` (`mesh.py`)."""
