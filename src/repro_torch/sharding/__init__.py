"""Logical-axis sharding rules and partition specs (port of
``repro/sharding``): :mod:`repro_torch.sharding.specs`."""
