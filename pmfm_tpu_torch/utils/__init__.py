"""Runtime utilities: benchmarking, CSV logging, profiling, debug checks,
checkpoints and AOT artifacts."""
from .benchmarker import CSV_FIELDS, Benchmarker
from .csv_logger import CSVLogger
from .profiling import device_sync

__all__ = ["Benchmarker", "CSVLogger", "CSV_FIELDS", "device_sync"]
