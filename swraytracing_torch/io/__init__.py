from . import binio, runmeta, checkpoint
from .binio import write_field, read_field, frame_count
from .runmeta import RunDir, parse_run_log
from .checkpoint import save_state, restore_state, latest_checkpoint

__all__ = ["binio", "runmeta", "checkpoint", "write_field", "read_field",
           "frame_count", "RunDir", "parse_run_log", "save_state",
           "restore_state", "latest_checkpoint"]
