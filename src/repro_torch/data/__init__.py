"""Synthetic input pipelines of the port (port of ``repro/data``): the
recsys batches (``recsys``).  The LM and graph pipelines come with their
slices."""
