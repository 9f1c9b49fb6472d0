"""Operators with hand-written kernels outside serving — the port of
``flexflow_tpu/ops`` as far as the training slice needs it:
:mod:`.flash_attention`."""
from . import flash_attention

__all__ = ["flash_attention"]
