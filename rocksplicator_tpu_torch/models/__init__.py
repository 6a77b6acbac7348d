"""The compaction pipeline as a module with a forward step."""

from .compaction_model import CompactionModel, synth_counter_batch

__all__ = ["CompactionModel", "synth_counter_batch"]
