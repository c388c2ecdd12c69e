"""Models, ported from ``repro.models``: the paper CNN for now."""
