"""Gated variants of the traversal and the pipeline (port of
fredholm_tpu/experimental/): the ray-resident traversal (resident.py,
FREDHOLM_TRAV_RESIDENT) and wavefront compaction (compact.py,
FREDHOLM_COMPACT). Both are off by default, as in the reference."""
