"""Preset scenes."""
