"""Training substrate of the port (port of ``repro/train``): AdamW with
global-norm clipping (``optimizer``), the train step and the fault-tolerant
loop (``loop``), atomic async checkpoints in the reference's on-disk format
(``checkpoint``), int8 gradient compression and its all-reduce
(``compression``) and the launcher-side fault tolerance (``fault``).  On a
process mesh the step is data-parallel and the update ZeRO-1's.  State trees are nested dicts,
tuples and lists of tensors, walked as ``jax.tree_util`` walks them
(``tree``)."""
