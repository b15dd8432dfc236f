"""The LM stack's models, as ``repro.models``: the decoder of every
family (``transformer``), its attention, MLP and experts (``attention``,
``mlp``, ``moe``), the state-space mixers (``mamba2``, ``rwkv6``), shared
primitives (``common``) and GQA head padding (``padding``)."""
