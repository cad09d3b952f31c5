"""Dataset generators, one module per name a configuration gives:
``generate(params, seed)`` returns {'Q', 'W', 'X', 'y'} for a
configuration's ``data`` and ``data_seed``."""
