"""Distributed pieces of the port.  Only the per-row ELL duplicate merge
of ``otamg/dist/assembly.py`` is ported so far; it serves the
single-process sparse-setup hierarchy."""
