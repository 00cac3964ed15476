"""Synthetic input pipelines of the port (port of ``repro/data``): the
recsys batches (``recsys``), the LM token batches (``lm``) and the graph
data (``graph``: power-law graphs, the fanout sampler, molecule batches)."""
