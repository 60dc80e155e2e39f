"""Command-line tools of the PyTorch port (run as ``python3 -m
lightgbm_tpu_torch.tools.<name>``)."""
