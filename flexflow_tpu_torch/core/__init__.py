"""Core helpers shared by model families — the port of
``flexflow_tpu/core`` as far as the training slice needs it:
:mod:`.remat`."""
from . import remat
from .remat import resolve_remat_policy

__all__ = ["remat", "resolve_remat_policy"]
