"""Launchers, ported from ``repro.launch``: the serving launcher (both
branches) and ``reduced_config`` of the training launcher."""
