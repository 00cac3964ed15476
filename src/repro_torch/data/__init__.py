"""Synthetic input pipelines of the port (port of ``repro/data``): the
recsys batches (``recsys``) and the LM token batches (``lm``).  The graph
pipeline comes with its slice."""
