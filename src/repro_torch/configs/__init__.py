"""Architecture/shape registry of the port (port of ``repro/configs``): the
four recsys configurations (``two-tower-retrieval``, ``dcn-v2``,
``autoint``, ``bst``) with their published ``CONFIG``, reduced ``SMOKE``
and shape set.  ``get_arch`` raises on an arch not ported yet."""
