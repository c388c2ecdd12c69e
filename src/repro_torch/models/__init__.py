"""Models, ported from ``repro.models``: the paper CNN, the VGG-style
streaming CNN and the dense transformer LM."""
