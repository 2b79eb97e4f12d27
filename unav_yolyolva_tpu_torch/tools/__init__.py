"""Measurement scripts of the port, run on the card as
`python -m unav_yolyolva_tpu_torch.tools.<name>`."""
