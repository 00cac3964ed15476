"""Entry points of the port (port of ``repro/launch``):
:mod:`repro_torch.launch.serve` serves a trace through the serving stack;
:mod:`repro_torch.launch.train` trains a recsys, LM or GNN arch with
checkpoints and fault injection; :mod:`repro_torch.launch.steps` builds
every cell (real tensors on a device, or shapes only on ``meta``);
:mod:`repro_torch.launch.mesh` the production and host meshes;
:mod:`repro_torch.launch.roofline` and :mod:`repro_torch.launch.dryrun`
count each cell's step on the production meshes against an H100 model."""
