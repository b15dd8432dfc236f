"""The LM stack's models, as ``repro.models``: the attention decoders
(``transformer``, ``attention``, ``mlp``, ``moe``, ``common``) and GQA
head padding (``padding``).  State-space and RWKV mixers come in ROADMAP
1.14.3."""
