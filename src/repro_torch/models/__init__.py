"""Model code (port of ``repro/models/``): ``layers`` and ``recsys``."""
