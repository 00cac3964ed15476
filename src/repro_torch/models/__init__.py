"""Model substrate of the port (port of ``repro/models``): parameter
definitions (``params``), shared layers (``layers``) and the recsys family
(``recsys``: two-tower retrieval with the geo blend, DCN-v2, AutoInt, BST),
forwards and differentiable losses."""
