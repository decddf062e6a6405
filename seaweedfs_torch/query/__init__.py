"""S3-Select-lite over JSON needles: the port's copy of
seaweedfs_tpu/query/ (``query_json_lines`` and its filter)."""

from .json_query import QueryFilter, project_doc, query_json_lines

__all__ = ["QueryFilter", "project_doc", "query_json_lines"]
