from .profiling import StageRecord, StageTimer, device_trace, timed_stage

__all__ = ["StageRecord", "StageTimer", "device_trace", "timed_stage"]
