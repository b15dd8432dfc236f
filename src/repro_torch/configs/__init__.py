"""Model configurations, as ``repro.configs``: ``base`` (``ModelConfig``),
one module per architecture and ``registry`` (``get``, ``smoke``,
``SHAPES``, ``cells``)."""
