"""Architecture/shape registry of the port (port of ``repro/configs``): the
four recsys configurations (``two-tower-retrieval``, ``dcn-v2``,
``autoint``, ``bst``), the five LMs (dense: ``smollm-135m``,
``qwen1.5-0.5b``, ``qwen2.5-14b``; MoE: ``olmoe-1b-7b``,
``granite-moe-1b-a400m``), the E(n)-equivariant GNN ``egnn`` and the
paper's ``geoweb``, each with its published ``CONFIG``, reduced ``SMOKE``
and shape set: every arch of the reference."""
