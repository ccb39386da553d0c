"""Model code (port of ``repro/models/``): ``layers``, ``recsys``,
``attention`` and the dense ``transformer``."""
