"""Examples of the port (port of the repository's ``examples/``), run as
``python -m repro_torch.examples.<name> [--device cpu]``."""
