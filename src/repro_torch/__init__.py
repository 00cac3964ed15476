"""PyTorch/CUDA port of the geo search engine (``repro``'s JAX package).

The port mirrors the reference's layout — ``core/``, ``corpus/``,
``kernels/<name>/{ops,ref,kernel}.py``, ``serving/``, ``obs/``,
``launch/`` — so each module's counterpart is found by path.  It imports
``torch`` and numpy only, never ``jax`` or ``repro``.

Entry points (:meth:`repro_torch.core.engine.GeoSearchEngine.build`,
:func:`repro_torch.serving.factory.make_executor`, ``python -m
repro_torch.launch.serve``) run on the CUDA device unless the caller passes
``device="cpu"`` (``--device cpu``); see :func:`resolve_device`.
"""
from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
