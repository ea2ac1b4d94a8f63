"""Configs: typed dataclasses and the shipped presets."""
