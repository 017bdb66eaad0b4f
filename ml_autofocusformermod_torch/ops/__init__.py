"""Geometry ops and the fused kernels' wrappers (no module here builds or
loads a kernel at import time)."""
