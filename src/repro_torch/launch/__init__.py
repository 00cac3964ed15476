"""Command-line entry points of the port (port of ``repro/launch``):
:mod:`repro_torch.launch.serve` serves a trace through the serving stack."""
