"""The LM stack's models, as ``repro.models``: the dense decoder
(``transformer``, ``attention``, ``mlp``, ``common``) and GQA head padding
(``padding``).  Experts, state-space and RWKV mixers come in later slices
of ROADMAP 1.14."""
