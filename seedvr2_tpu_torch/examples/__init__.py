"""Example scripts of the port: `python -m seedvr2_tpu_torch.examples.<name>`.
Importing them runs nothing."""
