"""The batched multi-folio pipeline of the port: ``process_batch``."""

from .batch import FolioResult, process_batch

__all__ = ["FolioResult", "process_batch"]
