"""Run output and audits (counterpart of ``thermalporous_tpu/io``):
checkpoints with exact resume, JSON-lines metrics, VTK ImageData series,
the material and energy balance audit, and the native I/O runtime."""

from thermalporous_torch.io.balance import BalanceAuditor, format_balance
from thermalporous_torch.io.checkpoint import (
    CheckpointManager,
    load_checkpoint,
    save_checkpoint,
)
from thermalporous_torch.io.metrics import MetricsLogger
from thermalporous_torch.io.vti import PVDWriter, state_fields, write_vti

__all__ = [
    "BalanceAuditor",
    "format_balance",
    "CheckpointManager",
    "load_checkpoint",
    "save_checkpoint",
    "MetricsLogger",
    "PVDWriter",
    "state_fields",
    "write_vti",
]
