"""Models, ported from ``repro.models``: the paper CNN, the VGG-style
streaming CNN, and the transformer LM with its dense MLP or its
mixture-of-experts layer (``moe``)."""
