"""Entry points of the port (port of ``repro/launch``):
:mod:`repro_torch.launch.serve` serves a trace through the serving stack;
:mod:`repro_torch.launch.train` trains a recsys arch with checkpoints and
fault injection; :mod:`repro_torch.launch.steps` builds the recsys cells
(train, serving and retrieval steps with their inputs on the device)."""
