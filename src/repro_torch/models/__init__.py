"""Model substrate of the port (port of ``repro/models``): parameter
definitions (``params``), shared layers (``layers``: RMSNorm, RoPE, flash
attention, SwiGLU), the recsys family (``recsys``: two-tower retrieval
with the geo blend, DCN-v2, AutoInt, BST; forwards and differentiable
losses), the Mixture-of-Experts FFN (``moe``: grouped capacity dispatch),
the decoder-only LM (``transformer``, dense or MoE: forward and a
differentiable loss, prefill and decode) and the E(n)-equivariant GNN
(``egnn``: forward and a differentiable loss over ordered segment sums)."""
