"""Launchers, ported from ``repro.launch``: the serving launcher."""
