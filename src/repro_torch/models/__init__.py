"""Models, ported from ``repro.models``: the paper CNN, the VGG-style
streaming CNN, the transformer LM with its dense MLP or its
mixture-of-experts layer (``moe``), the Mamba2 hybrid (``mamba2``,
``hybrid``) and the RWKV-6 LM (``rwkv6``, ``rwkv_lm``)."""
