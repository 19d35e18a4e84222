"""CSV logger — same role and schema as the reference CSV_Logger
(CSV_Logger.hpp:13-38): header row written from the field list at open,
``add_record`` appends one row. The pure-Python path of
``pmfm_tpu/utils/csv_logger.py`` (the optional native logger is not ported);
both write identical files.
"""
from __future__ import annotations

import os
from typing import Iterable, Sequence


class CSVLogger:
    def __init__(self, path: str | os.PathLike, field_names: Sequence[str]):
        self.path = os.fspath(path)
        self.field_names = list(field_names)
        parent = os.path.dirname(self.path)
        if parent:
            os.makedirs(parent, exist_ok=True)
        self._fh = open(self.path, "w")
        self._fh.write(",".join(self.field_names) + "\n")
        self._fh.flush()

    def add_record(self, record: Iterable) -> None:
        """Append one row (CSV_Logger.hpp:28-38)."""
        row = [str(x) for x in record]
        if len(row) != len(self.field_names):
            raise ValueError(
                f"record has {len(row)} fields, header has {len(self.field_names)}"
            )
        self._fh.write(",".join(row) + "\n")
        self._fh.flush()

    def close(self) -> None:
        self._fh.close()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
