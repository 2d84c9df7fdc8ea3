"""Embedded (ARM MCU) deployment analysis: ``arm/analysis.py``."""
