"""Config dataclasses and device helpers."""
