"""Model substrate of the port (port of ``repro/models``): parameter
definitions (``params``), shared layers (``layers``: RMSNorm, RoPE, flash
attention, SwiGLU), the recsys family (``recsys``: two-tower retrieval
with the geo blend, DCN-v2, AutoInt, BST; forwards and differentiable
losses) and the dense decoder-only LM (``transformer``: forward, loss
value, prefill and decode)."""
