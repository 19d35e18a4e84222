"""Runtime utilities: benchmarking, CSV logging, profiling, debug checks."""
from .benchmarker import CSV_FIELDS, Benchmarker
from .csv_logger import CSVLogger

__all__ = ["Benchmarker", "CSVLogger", "CSV_FIELDS"]
